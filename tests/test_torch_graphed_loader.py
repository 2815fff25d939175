"""The loaders' featurize call and the F0 cache's pYIN, which the port runs
through ``utils/graphs.Graphed`` (CUDA graphs on the card, the same code
eagerly here), at small sizes on the CPU:

* nothing the featurizer's graph runs waits on the device from the host
  (a capture refuses it), and a warm call uploads no host array, for
  pYIN, YIN, cached F0 tracks, mel noise and the distance transform;
* a capturing thread's launch and collective tallies go to its capture's
  record, while another thread's reach the counters;
* the training and the validation loaders read one ``Featurizer`` from
  their two threads at once and get the batches they get one after the
  other, and the JAX package's loaders' batches within
  ``tests/test_torch_featurizer.py::test_featurizer_matches_jax``'s
  tolerances (mel 1e-4 absolute, energy and p_voiced 1e-5, the prior
  1e-4 relative, log F0 1e-4 relative and 1e-5 absolute, voicing
  exactly);
* ``build_f0_cache(frames_multiple=32)`` against the JAX package's
  within ``tests/test_torch_f0_cache.py``'s bounds (F0 1e-5 relative on
  voiced frames, p_voiced 1e-6, voicing equal).

The graphs themselves: ``tests/test_torch_graphs_cuda.py`` (card only)
and ``chip_smoke.py``'s featurize, caches and graphs phases."""
import collections
import threading

import numpy as np
import pytest
import torch

from radmmm_tpu.data.f0_cache import build_f0_cache as jax_build_f0_cache
from radmmm_tpu.data.loader import DataLoader as JaxDataLoader
from radmmm_torch.data import collate
from radmmm_torch.data.f0_cache import build_f0_cache, f0_key
from radmmm_torch.data.loader import DataLoader
from radmmm_torch.native import FeatureCache
from radmmm_torch.parallel import collectives
from radmmm_torch.training import step as tstep
from radmmm_torch.training.loop import Trainer, TrainerConfig
from radmmm_torch.utils import launches
from radmmm_torch.utils.launches import launch_counts, launched
from tests.test_torch_f0_cache import F0_RTOL, PVOICED_ATOL, _modules
from tests.test_torch_featurizer import REG, _items
from tests.test_torch_fit import cfg_files  # noqa: F401  (module fixture)
from tests.test_torch_megastep import FEAT, _NoHostWaits
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_tts_model import tiny_config

SR = 22050
# tests/test_torch_megastep.py's featurizer without its mel noise
QUIET = dict(FEAT, mel_noise_scale=0.0)
# each kind of signature the featurizer's graphs are keyed on
KINDS = {"pyin": dict(f0_method="pyin"), "yin": dict(f0_method="yin"),
         "cached_f0": dict(f0_method="pyin"),
         "noise": dict(f0_method="pyin", mel_noise_scale=0.05),
         "distance": dict(f0_method="pyin", distance_tx_unvoiced=True)}


def _host(kind: str, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    items = _items(rng, B=2, n_text=7, seconds=(0.19, 0.16))
    if kind == "cached_f0":
        for it in items:
            n = 1 + len(it["audio"]) // FEAT["hop_length"]
            it["cached_f0"] = np.stack([
                rng.uniform(100, 300, n), rng.integers(0, 2, n),
                rng.uniform(0, 1, n)]).astype(np.float32)
    return collate.collate_host(items, hop_length=FEAT["hop_length"],
                                audio_frames_multiple=16)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_featurizer_graph_never_waits_nor_uploads(kind, monkeypatch):
    """A featurize call runs no op that needs a device value on the host,
    and once warm its graph's program turns no host array into a tensor
    (on the card a copy from pageable memory, which a capture refuses):
    the call's arrays go up before the program, its noise is drawn before
    it."""
    feat = collate.Featurizer(device="cpu", **{**QUIET, **KINDS[kind]})
    host = _host(kind)
    watch = _NoHostWaits()
    with watch:
        first = feat(host)
        inputs = feat.program_inputs(
            {k: torch.from_numpy(v) for k, v in feat.raw_arrays(host).items()},
            feat.noise_key_for_step(0))
        uploads = []
        from_numpy = torch.from_numpy
        monkeypatch.setattr(torch, "from_numpy", lambda a: uploads.append(
            a.shape) or from_numpy(a))
        warm = feat._program(inputs, key=(feat.f0_method,))
        monkeypatch.setattr(torch, "from_numpy", from_numpy)
    assert watch.seen == [] and uploads == []
    assert ("noise" in inputs) == (kind == "noise")
    assert ("cached_f0" in inputs["raw"]) == (kind == "cached_f0")
    if kind != "noise":
        for k, v in warm.items():
            assert torch.equal(v, first[k]), k


def test_a_capture_records_its_own_threads_tallies_only():
    """While one thread captures (``begin_capture`` to ``end_capture``),
    another thread's launches and collectives (an eager step, a replay)
    reach the counters and the capture records only its own: a loader's
    featurize capture takes nothing of the trainer's steps."""
    launch_counts.clear()
    collectives.reset_stats()
    began, other_done = threading.Event(), threading.Event()
    added = []

    def capture():
        launches.begin_capture()
        began.set()
        launched("ctc_alpha")
        other_done.wait(10)
        collectives._record("all_reduce", torch.zeros(4))
        added.append(launches.end_capture())

    t = threading.Thread(target=capture)
    t.start()
    began.wait(10)
    for _ in range(3):
        launched("mas_width1")
    collectives._record("all_gather", torch.zeros(2))
    other_done.set()
    t.join(10)
    assert launch_counts == {"mas_width1": 3}
    assert dict(collectives.STATS) == {("all_gather", "count"): 1,
                                       ("all_gather", "bytes"): 8}
    (record,) = added
    assert record[0] == {"ctc_alpha": 1}
    launches.add_record(record)
    assert launch_counts == {"mas_width1": 3, "ctc_alpha": 1}
    assert collectives.STATS[("all_reduce", "count")] == 1
    launch_counts.clear()
    collectives.reset_stats()


def _loaders(dm, featurizer):
    """The training loader (shuffled, one thread) and the validation
    loader of ``dm``, both featurizing with ``featurizer``."""
    train = DataLoader(dm.trainset, 2, shuffle=True, featurizer=featurizer,
                       num_threads=1, seed=7, hop_length=256)
    val = DataLoader(dm.valset, 2, shuffle=False, featurizer=featurizer,
                     num_threads=1, hop_length=256, uniform_shape=True)
    return train, val


def test_two_loaders_share_one_featurizer(cfg_files):  # noqa: F811
    """The training loader's thread and the validation loader's thread
    featurize through one ``Featurizer`` at once (as ``validate`` starts
    its loader while the training loader prefetches): the batches those
    of one loader after the other, bit for bit, and the JAX package's
    loaders' batches (its featurizer) within the module docstring's
    tolerances."""
    dm, jdm = _modules(cfg_files, use_wave_augmentations=False)
    train, val = _loaders(dm, dm.featurizer)
    apart = [list(train), list(val)]
    dm2, _ = _modules(cfg_files, use_wave_augmentations=False)
    train, val = _loaders(dm2, dm2.featurizer)
    together = [None, None]
    start = threading.Barrier(2)

    def read(i, loader):
        start.wait(10)
        together[i] = list(loader)

    threads = [threading.Thread(target=read, args=(i, ld))
               for i, ld in enumerate((train, val))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert [len(b) for b in together] == [len(b) for b in apart] == [4, 4]
    for got_set, want_set in zip(together, apart):
        for got, want in zip(got_set, want_set):
            assert set(got) == set(want)
            for k, v in want.items():
                if isinstance(v, torch.Tensor):
                    assert torch.equal(got[k], v), k
                else:
                    assert got[k] == v, k

    jtrain = JaxDataLoader(jdm.trainset, 2, shuffle=True,
                           featurizer=jdm.featurizer, num_threads=1, seed=7,
                           hop_length=256, process_index=0, process_count=1)
    jval = JaxDataLoader(jdm.valset, 2, shuffle=False,
                         featurizer=jdm.featurizer, num_threads=1,
                         hop_length=256, uniform_shape=True, process_index=0,
                         process_count=1)
    for got_set, jloader in zip(apart, (jtrain, jval)):
        want_set = list(jloader)
        assert len(want_set) == len(got_set)
        for got, want in zip(got_set, want_set):
            _close_to_jax(got, want)


def _close_to_jax(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in ("audio", "text", "input_lengths", "output_lengths",
              "speaker_ids", "accent_ids", "idx", "speaker_f0_mean"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["audiopaths"] == want["audiopaths"]

    def close(k, **tol):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **tol)

    close("mel", atol=1e-4, rtol=0)
    close("energy_avg", atol=1e-5, rtol=0)
    close("attn_prior", rtol=1e-4, atol=1e-30)
    np.testing.assert_array_equal(got["voiced_mask"].numpy(),
                                  np.asarray(want["voiced_mask"]))
    close("p_voiced", atol=1e-5, rtol=0)
    close("f0", rtol=1e-4, atol=1e-5)


def test_build_f0_cache_frames_multiple_matches_jax(cfg_files,  # noqa: F811
                                                    tmp_path):
    """``frames_multiple`` pads each batch as the JAX builder's does: at
    32 the tracks of the corpus's eight utterances equal the JAX cache's
    within the bounds of tests/test_torch_f0_cache.py."""
    dm, jdm = _modules(cfg_files, use_wave_augmentations=False)
    port_path, jax_path = str(tmp_path / "port"), str(tmp_path / "jax")
    n = build_f0_cache(dm.trainset, port_path, batch_size=4,
                       frames_multiple=32, device="cpu")
    m = jax_build_f0_cache(jdm.trainset, jax_path, batch_size=4,
                           frames_multiple=32)
    assert n == m == len(dm.trainset) == 8
    port, jax_c = FeatureCache(port_path), FeatureCache(jax_path)
    for i in range(len(dm.trainset)):
        item = dm.trainset[i]
        key = f0_key(item["audiopath"])
        got, want = port.get_array(key), jax_c.get_array(key)
        assert got.shape == want.shape == (3, 1 + len(item["audio"]) // 256)
        np.testing.assert_array_equal(got[1], want[1], err_msg=key)
        v = want[1] > 0
        assert v.mean() > 0.8, key
        np.testing.assert_allclose(got[0][v], want[0][v], rtol=F0_RTOL)
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=PVOICED_ATOL)


def test_trainer_gives_the_loaders_featurizer_a_pool_of_its_own(tmp_path):
    """The trainer hands the data module's featurizer a new pool, apart
    from its steps' (the loaders' threads replay it while the steps
    replay theirs); the eager seam (``_featurizer_pool`` None) makes the
    featurizer eager."""

    class Eager(Trainer):
        def _featurizer_pool(self):
            return None

    Data = collections.namedtuple("Data", "featurizer")
    pools = []
    for cls in (Trainer, Eager):
        tr = cls(tiny_config(), tstep.LossConfig(**REG), TrainerConfig(
            output_directory=str(tmp_path / cls.__name__), device="cpu",
            save_code_snapshot=False))
        dm = Data(collate.Featurizer(device="cpu", **QUIET))
        own = dm.featurizer.pool
        tr._graph_featurizer(dm)
        assert dm.featurizer.pool is tr._feature_pool is not own
        pools.append(tr._feature_pool)
        assert dm.featurizer.pool is not tr._graph_pool
    assert pools[0] is not None and pools[1] is None
