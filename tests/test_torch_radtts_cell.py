"""The benchmark's RAD-TTS training cell (``radtts.train.f0cache``) at a
tiny size on the CPU, through its traffic kind
(``portbench/traffic/train_f0cache.py``): the plain reference matches the
port (``correct`` true), a step that returns its state unchanged and a
half batch each come out not ``correct``, and the reference's own parts
(``portbench/reference/radtts.py``: ``LSTMConvDAP`` and the cached-F0
featurize) match the port's. The ``cuda`` case holds the device marks of
a graphed step on the card: ``python -m pytest
tests/test_torch_radtts_cell.py -m cuda --noconftest``."""
import copy
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import radtts as ref_radtts
from portbench.reference.train import half
from portbench.reference.frozen.utils.masking import SeqLens as RefLens
from radmmm_torch.data.collate import Featurizer
from radmmm_torch.models.attributes import LSTMConvDAP
from radmmm_torch.utils.masking import SeqLens
from tests.test_torch_threads import one_torch_thread  # noqa: F401

CELL = "radtts.train.f0cache"
SEED = 2 ** 31 + 203
FRAMES = dict(n_speaker_dim=4, in_dim=16, out_dim=1, reduction_factor=2,
              n_backbone_layers=2, n_hidden=8, p_dropout=0.5,
              lstm_type="bilstm")
# RAD-TTS's predictors at tiny widths: frame kernels 15 / 3 / 15 and the
# LSTM-first duration head
TTS = dict(
    n_text_tokens=30, n_text_dim=16, n_speakers=2, n_speaker_dim=4,
    n_augmentations=2, use_accent=True, n_accents=2, n_accent_dim=2,
    n_mel_channels=8, use_accent_emb_for_encoder=False,
    use_accent_emb_for_alignment=False, use_speaker_emb_for_alignment=False,
    lstm_norm_fn="spectral",
    decoder=dict(n_speaker_dim=4, use_accent=True, n_accent_dim=2,
                 use_accent_emb_for_decoder=True, n_text_dim=16,
                 use_context_lstm=True, n_f0_dims=1, n_energy_avg_dims=1,
                 n_mel_channels=8, n_flows=2, n_conv_layers_per_step=1,
                 n_early_size=2, n_early_every=2, n_group_size=2,
                 affine_model="wavenet", scaling_fn="tanh",
                 use_partial_padding=True),
    f0_predictor=dict(FRAMES, kernel_size=15, target_offset=-5),
    energy_predictor=dict(FRAMES, kernel_size=3, target_offset=-0.75),
    voiced_predictor=dict(FRAMES, kernel_size=15),
    duration_predictor=dict(_class="LSTMConvDAP", n_speaker_dim=4,
                            in_dim=16, out_dim=1, reduction_factor=2,
                            n_backbone_layers=3, n_hidden=8, kernel_size=3,
                            p_dropout=0.5, log_target=True))


def tiny_cell():
    """The cell with the tiny model, 8 mel channels and 16 short clips in
    8 batches of 2: two shapes, (64, 16) for the longest 2 batches."""
    cell = copy.deepcopy(harness.workload(CELL))
    cs = cell["config_spec"]
    cs["tts"] = copy.deepcopy(TTS)
    cs["featurizer"]["n_mel_channels"] = 8
    cell["traffic"].update(batch=2, clips=16, frames_multiple=32,
                           text_multiple=16, tokens_per_second=30.0,
                           seconds=dict(min=0.2, mode=0.3, max=0.5))
    return cell


_REFERENCE = {}


@pytest.fixture
def once_reference(monkeypatch):
    """The reference's compared steps run once for the module: they
    depend on the cell and the seed alone, which every run here shares."""
    from portbench.reference import train_f0cache
    run = train_f0cache.run

    def cached(*args, **kw):
        if "reads" not in _REFERENCE:
            _REFERENCE["reads"] = run(*args, **kw)
        return _REFERENCE["reads"]
    monkeypatch.setattr(train_f0cache, "run", cached)


def _run(hooks=None):
    cell = tiny_cell()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    return kind.run(cell, SEED, 0.2, False, t0=time.perf_counter(),
                    device="cpu", hooks=hooks)


def _correct(out):
    return all(c["ok"] for c in out["checks"])


def test_the_tiny_traffic_has_two_shapes():
    cell = tiny_cell()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    cs, p = cell["config_spec"], cell["traffic"]
    hosts = kind.make_batches(p, cs, kind.make_items(p, cs, SEED))
    shapes = sorted({(h["audio"].shape[1] // 256, h["text"].shape[1])
                     for h in hosts})
    assert len(hosts) == 8 and shapes == [(32, 16), (64, 16)]


def test_reference_matches_the_port(once_reference):
    out = _run()
    assert _correct(out), out["checks"]
    assert out["attempted"] > 0


def _unchanged(prog):
    def step(raw):
        before = [p.detach().clone() for p in prog.model.parameters()]
        met = prog(raw)
        with torch.no_grad():
            for p, q in zip(prog.model.parameters(), before):
                p.copy_(q)
        return met
    return step


def _half_batch(prog):
    return lambda raw: prog(half(raw))


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault, once_reference):
    assert not _correct(_run({"step": fault}))


def test_reference_lstm_conv_dap_matches_the_port():
    cfg = {k: v for k, v in TTS["duration_predictor"].items()
           if k != "_class"}
    torch.manual_seed(0)
    port = LSTMConvDAP(**cfg)
    ref = ref_radtts.LSTMConvDAP(**cfg)
    ref.load_state_dict(port.state_dict())
    g = torch.Generator().manual_seed(1)
    x, spk = torch.randn(3, 12, 16, generator=g), torch.randn(3, 4)
    lens = torch.tensor([12, 9, 5])
    got = port(x, spk, SeqLens.create(lens, 12), train=True,
               generator=torch.Generator().manual_seed(5))
    want = ref(x, spk, RefLens.create(lens, 12), train=True,
               generator=torch.Generator().manual_seed(5))
    # the same float32 operations in the same order on either side; the
    # tolerance leaves room for the library picking another summation
    # order between the two modules' calls, a few units of the last place
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_reference_cached_f0_featurize_matches_the_port():
    cell = tiny_cell()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    cs, p = cell["config_spec"], cell["traffic"]
    items = kind.make_items(p, cs, SEED)[:2]
    rng = np.random.default_rng(4)
    tracks = [np.stack([rng.uniform(60, 300, n), rng.integers(0, 2, n),
                        rng.uniform(0, 1, n)]).astype(np.float32)
              for n in (1 + len(x["audio"]) // 256 for x in items)]
    raw = kind.raw_batches(dict(p, batch=2), cs, items, tracks)[0]
    t = {k: torch.from_numpy(v) for k, v in raw.items()}
    got = Featurizer(**cs["featurizer"], device="cpu",
                     pool=None).featurize_raw(t, None)
    want = ref_radtts.Featurizer(**cs["featurizer"]).featurize_raw(t)
    assert got.keys() == want.keys()
    for k in got:
        # the mel's STFT and log on either side are the same float32
        # operations; the tolerance leaves a few units of the last place
        # for the library's summation order
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


@pytest.mark.cuda
def test_a_graphed_step_replays_its_marks():
    """A graphed RAD-TTS step at one shape, the third call (a replay)
    profiled: ``train.featurize`` once, ``train.align`` (attention and
    CTC) and ``train.attributes`` once or more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cell = tiny_cell()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    cs = cell["config_spec"]
    dev = torch.device("cuda")
    raws, _ = kind.traffic(cell, SEED, dev)
    prog = kind.Program(cs, SEED, dev)
    raw = {k: torch.from_numpy(v).to(dev) for k, v in raws[0].items()}
    prog.whiten(raw)
    for _ in range(2):
        prog(raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prog(raw)
        torch.cuda.synchronize()
    assert prog.pool.replays >= 1
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]

    def runs(mark):
        return sum(n == f"radmmm_mark_{mark}_begin" for n in names)
    assert runs("train_featurize") == 1
    assert runs("train_align") >= 1 and runs("train_attributes") >= 1
