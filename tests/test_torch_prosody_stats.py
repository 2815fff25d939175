"""radmmm_torch.scripts.compute_speaker_prosody_statistics against the JAX
package's scripts/compute_speaker_prosody_statistics.py (loaded from its
file), both on tests/test_torch_fit.py's two-speaker corpus and config
(whose augmentation and stats file the scripts turn off): the same
speaker files and collated_stats.json, every key of every speaker within
rtol 1e-5 (F0 from each package's own pYIN, measured within 6e-7 of each
other on these tones; energy from the same log-mel, within 1e-6), and
``load_speaker_stats`` reads the port's file. A second run without
--overwrite reads the files back; with it, recomputes them."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from radmmm_torch.data.dataset import load_speaker_stats
from radmmm_torch.scripts import compute_speaker_prosody_statistics as stats
from tests.test_torch_fit import cfg_files  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
KEYS = ("f0_median", "f0_mean", "f0_std", "log_f0_median", "log_f0_mean",
        "log_f0_std", "energy_mean", "energy_std")
RTOL = 1e-5


@pytest.fixture(scope="module")
def outputs(cfg_files):
    path, _, out = cfg_files
    port_dir, jax_dir = out / "stats_port", out / "stats_jax"
    got = stats.main(["-c", path, "-o", str(port_dir), "--device", "cpu"])
    spec = importlib.util.spec_from_file_location(
        "jax_prosody_stats",
        REPO / "scripts" / "compute_speaker_prosody_statistics.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["stats", "-c", path, "-o", str(jax_dir)])
        mod.main()
    return dict(path=path, port=port_dir, jax=jax_dir, returned=got)


def _load(d, name):
    with open(d / name) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["spk_a.json", "spk_b.json",
                                  "collated_stats.json"])
def test_stats_match_jax(outputs, name):
    got, want = _load(outputs["port"], name), _load(outputs["jax"], name)
    assert set(got) == set(want)
    if name == "collated_stats.json":
        assert sorted(got) == ["spk_a", "spk_b"]
        assert got == outputs["returned"]
        pairs = [(got[s], want[s]) for s in want]
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
    # the tones' pitch: spk_a's utterances sit at 150-240 Hz, spk_b's at
    # 180-280 Hz (write_corpus)
    for g, _ in pairs:
        assert 140 < g["f0_median"] < 290 and g["f0_std"] > 0
        np.testing.assert_allclose(np.exp(g["log_f0_median"]),
                                   g["f0_median"], rtol=1e-3)


def test_load_speaker_stats_reads_the_port_output(outputs):
    table = load_speaker_stats(str(outputs["port"] / "collated_stats.json"))
    assert set(table) == {"spk_a", "spk_b"}
    assert table["spk_b"]["log_f0_mean"] == _load(
        outputs["port"], "spk_b.json")["log_f0_mean"]


def test_existing_files_are_kept_unless_overwrite(outputs, tmp_path):
    d = tmp_path / "stats"
    d.mkdir()
    planted = dict.fromkeys(KEYS, 1.0)
    (d / "spk_a.json").write_text(json.dumps(planted))
    kept = stats.main(["-c", outputs["path"], "-o", str(d), "--device",
                       "cpu"])
    assert kept["spk_a"] == planted
    assert kept["spk_b"] == _load(outputs["port"], "spk_b.json")
    redone = stats.main(["-c", outputs["path"], "-o", str(d), "--device",
                         "cpu", "--overwrite"])
    assert redone["spk_a"] == _load(outputs["port"], "spk_a.json")
