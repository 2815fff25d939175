"""The trainer's inference programs and the vocoder training steps, which
the port runs through ``utils/graphs.Graphed`` (CUDA graphs on the card,
the same code eagerly here), at tiny widths on the CPU:

* nothing ``Graphed`` runs waits on the device from the host (a capture
  refuses it), and a warm call uploads no host array: the sample
  ``infer``, the binarized eval forward, ``reconstruct``, HiFi-GAN's and
  WaveGlow's apply with the Denoiser, and both vocoder training steps;
* the trainer's samples are the draws ``model.infer`` and
  ``model.reconstruct`` make from the same seeded generators, bit for bit
  (the latent is drawn outside the programs and passed in);
* after a training step the samples read each flow 1x1's inverse of the
  new weights, from the storage the first validation's graphs read;
* the vocoder trainers on the port's ``Optimizer``: the moments and
  count through ``state_dict``, and a ``torch.optim`` state dict of a run
  directory written before it.

The graphs themselves: ``tests/test_torch_graphs_cuda.py`` (card only) and
``chip_smoke.py``'s graphs and vocoder phases. Against JAX:
``test_torch_vocoder_train.py`` and ``test_torch_waveglow.py``."""
import collections
import copy
import dataclasses

import numpy as np
import pytest
import torch

from radmmm_torch.data import collate
from radmmm_torch.models.tts import TTSConfig
from radmmm_torch.training import step as tstep
from radmmm_torch.training import vocoder_train as tvt
from radmmm_torch.training.loop import Trainer, TrainerConfig
from radmmm_torch.utils.graphs import Graphed
from radmmm_torch.vocoder.hifigan import (Denoiser, Generator, HiFiGANConfig,
                                          blur_draws, blur_generator)
from radmmm_torch.vocoder.utils import WaveGlowFn, hifigan_fns, vocode_program
from radmmm_torch.vocoder.waveglow import WaveGlow
from tests.test_torch_featurizer import REG
from tests.test_torch_megastep import FEAT, _NoHostWaits, _raws
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_tts_model import tiny_config

MAX_FRAMES = 32
GEN = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
           resblock_dilation_sizes=((1, 3),), n_mel_channels=8)
WG = dict(n_mel_channels=8, n_flows=4, n_group=4, n_early_every=2,
          n_early_size=2, wn_channels=8, wn_layers=2, hop_length=16,
          upsample_kernel=32)
VOC_TRAIN = dict(segment_size=512, hop_length=16, filter_length=64,
                 win_length=64, n_mel_channels=8, learning_rate=1e-3)


@pytest.fixture(scope="module")
def batch():
    """A featurized batch of two utterances."""
    feat = collate.Featurizer(device="cpu", **FEAT)
    return feat.featurize_raw({k: torch.from_numpy(a)
                               for k, a in _raws()[0].items()}, 0)


def _trainer(tmp_path) -> tuple:
    tr = Trainer(TTSConfig(**dataclasses.asdict(tiny_config())),
                 tstep.LossConfig(**REG),
                 TrainerConfig(output_directory=str(tmp_path), device="cpu",
                               max_infer_frames=MAX_FRAMES, hop_length=64,
                               learning_rate=1e-2, save_code_snapshot=False))
    return tr, tr._init_state(None)


def _prompts(n_text=(6, 4)):
    rng = np.random.default_rng(3)
    return [{"text_encoded": rng.integers(1, 30, n), "spk_id": i % 3,
             "decoder_spk_id": (i + 1) % 3, "duration_spk_id": i % 3,
             "f0_spk_id": i % 3, "energy_spk_id": (i + 2) % 3,
             "accent_id": i % 2, "speaker_f0_mean": 5.0 + 0.1 * i,
             "speaker_f0_std": 0.3, "idx": i}
            for i, n in enumerate(n_text)]


class _Record:
    """What the trainer hands its vocoder, and what it logs."""

    def __init__(self, tr, monkeypatch):
        self.mels, self.scalars = [], []
        monkeypatch.setattr(tr, "_vocode", lambda m: self.mels.append(
            m.clone()) or torch.zeros(m.shape[0], m.shape[1] * 64))
        monkeypatch.setattr(tr.logger, "scalars",
                            lambda tag, d, step: self.scalars.append(d))


def _tiny_vocoders():
    """HiFi-GAN and WaveGlow (its couplings' ``end`` convs nonzero, so
    none is the identity) with their Denoisers, seeded."""
    torch.manual_seed(0)
    gen = Generator(HiFiGANConfig(**GEN))
    wg = WaveGlow(**WG)
    with torch.no_grad():
        for i in range(wg.n_flows):
            getattr(wg, f"wn_{i}").end.weight.normal_(0.0, 1e-2)
    fn, _ = hifigan_fns(gen, False, torch.device("cpu"))
    wfn = WaveGlowFn(wg.eval().cache_inverses(), torch.device("cpu"))
    return [(f, Denoiser(at_0, n_mel_channels=8, filter_length=64,
                         win_length=64, device="cpu"))
            for f, at_0 in ((fn, fn), (wfn, lambda m: wfn(m, sigma=0.0)))]


def _crops(seed: int, B: int = 2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((B, VOC_TRAIN["segment_size"]), generator=g) * 0.6 \
        - 0.3


def test_graphed_programs_never_wait_on_the_device(tmp_path, batch,
                                                   monkeypatch):
    """Every ``Graphed`` call of the trainer's samples, predict and
    vocoding and of both vocoder steps runs no op that makes the host
    wait (``_linalg_check_errors`` included: the samples read each 1x1's
    inverse from its cache, refreshed outside the programs), and none
    turns a host array into a tensor once its name has run before. Each
    program is called twice, the GAN step four times with blur_p 0.5
    from seed 1, so both branches run (steps 0 and 2 blur)."""
    watch, calls, uploads = _NoHostWaits(), collections.Counter(), []
    call = Graphed.__call__
    from_numpy = torch.from_numpy

    def watched(self, inputs, key=()):
        if calls[self.name]:
            monkeypatch.setattr(torch, "from_numpy", lambda a: uploads.append(
                (self.name, a.shape)) or from_numpy(a))
        calls[self.name] += 1
        try:
            with watch:
                return call(self, inputs, key)
        finally:
            monkeypatch.setattr(torch, "from_numpy", from_numpy)

    monkeypatch.setattr(Graphed, "__call__", watched)
    tr, _ = _trainer(tmp_path)
    tr.model.cache_inverses()
    b = tr._predict_batch(_prompts())
    (fn, den), (wfn, wden) = _tiny_vocoders()
    hifigan = vocode_program("hifigan", fn, den, tr._graph_pool)
    waveglow = vocode_program("waveglow", wfn, wden, tr._graph_pool)
    gan = tvt.HiFiGANTrainer(HiFiGANConfig(**GEN), tvt.VocoderTrainConfig(
        **VOC_TRAIN, blur_p=0.5, seed=1), device="cpu")
    assert [blur_draws(blur_generator(1, i), 4, 0.5)[1]
            for i in range(4)] == [True, False, True, False]
    wgt = tvt.WaveGlowTrainer({k: v for k, v in WG.items()
                               if k != "hop_length"},
                              tvt.VocoderTrainConfig(**VOC_TRAIN),
                              device="cpu")
    with torch.no_grad():
        for _ in range(2):
            out = tr._infer(b, tr._generator(0))
            tr._val_forward(batch)
            tr._reconstruct(batch, tr._generator(0))
            hifigan(out["mel"])
            waveglow(out["mel"])
    for i in range(4):
        gan.train_step({"audio": _crops(i)})
    for i in range(2):
        wgt.train_step({"audio": _crops(i)})
    assert watch.seen == [] and uploads == []
    assert calls == {"tts_infer": 2, "val_forward": 2, "reconstruct": 2,
                     "vocode": 4, "hifigan_step": 4, "waveglow_step": 2}
    assert gan.step == 4 and wgt.step == 2


def test_samples_are_the_seeded_draws(tmp_path, batch, monkeypatch):
    """The logged TTS samples are ``model.infer``'s from a generator of
    the trainer's seed, and the validation's reconstruction is
    ``model.reconstruct``'s from a generator seeded 0, bit for bit; the
    quality scalars are those of that reconstruction."""
    from radmmm_torch.utils.quality import reconstruction_quality
    tr, state = _trainer(tmp_path)
    rec = _Record(tr, monkeypatch)
    items = _prompts()
    tr._tts_prompts = items
    tr._log_tts_samples(state, None, 0)
    tr._log_val_samples(state, batch, 0)
    b = tr._predict_batch(items)
    model = copy.deepcopy(tr.model)
    with torch.no_grad():
        want = model.infer(
            b["text"], b["text_lens"], b["spk_id"],
            accent_ids=b["accent_id"], f0_mean=b["speaker_f0_mean"],
            f0_std=b["speaker_f0_std"], sigma=tr.cfg.sigma_infer,
            max_frames=MAX_FRAMES,
            generator=torch.Generator().manual_seed(tr.cfg.seed))["mel"]
        out = model(batch, binarize=True, train=False)
        want_rec = model.reconstruct(
            batch, generator=torch.Generator().manual_seed(0))["mel"]
    assert want.shape == (2, MAX_FRAMES, 8)
    assert torch.equal(rec.mels[0], want)
    assert torch.equal(rec.mels[1], want_rec[:1])
    host = {k: v.numpy() for k, v in batch.items()
            if isinstance(v, torch.Tensor)}
    assert rec.scalars[-1] == reconstruction_quality(
        host, want_rec.numpy(), {k: {n: t.numpy() for n, t in v.items()}
                                 for k, v in out.items()
                                 if isinstance(v, dict)})


def test_samples_after_a_step_read_the_new_inverses(tmp_path, batch,
                                                    monkeypatch):
    """A validation, a training step, a validation: each 1x1's cached
    inverse stays in the storage the first validation's programs read,
    and holds the inverse of the weights after the step; the second
    reconstruction is a fresh model's of those weights, and differs from
    the first."""
    tr, state = _trainer(tmp_path)
    rec = _Record(tr, monkeypatch)
    tr._log_val_samples(state, batch, 0)
    one_by_ones = [m for m in tr.model.modules() if hasattr(m, "w_inv")]
    ptrs = [m.w_inv.data_ptr() for m in one_by_ones]
    before = [m.w_inv.clone() for m in one_by_ones]
    state, _ = tr._train_step_fn(False, False)(state, batch,
                                               tr._generator(1))
    tr._log_val_samples(state, batch, 1)
    assert [m.w_inv.data_ptr() for m in one_by_ones] == ptrs
    for m, old in zip(one_by_ones, before):
        assert torch.equal(m.w_inv, m.inverse_weight())
        assert not torch.equal(m.w_inv, old)
    fresh = copy.deepcopy(tr.model).eval()
    for m in fresh.modules():
        if hasattr(m, "w_inv"):
            m.drop_inverse()
    with torch.no_grad():
        want = fresh.reconstruct(
            batch, generator=torch.Generator().manual_seed(0))["mel"][:1]
    assert torch.equal(rec.mels[1], want)
    assert not torch.equal(rec.mels[0], rec.mels[1])


def test_vocoder_trainers_resume_their_optimizers(tmp_path):
    """A GAN step and a WaveGlow step, ``state_dict`` into fresh trainers,
    a step each: bit for bit the trainers that took both steps. A
    ``torch.optim`` state dict of the same moments (a run directory
    written before the trainers took the port's ``Optimizer``) loads as
    the port's own."""
    def hifigan():
        return tvt.HiFiGANTrainer(HiFiGANConfig(**GEN), tvt.VocoderTrainConfig(
            **VOC_TRAIN, blur_p=0.5), device="cpu")

    def waveglow():
        return tvt.WaveGlowTrainer({k: v for k, v in WG.items()
                                    if k != "hop_length"},
                                   tvt.VocoderTrainConfig(**VOC_TRAIN),
                                   device="cpu")

    for make, modules in ((hifigan, ("gen", "mpd", "msd")),
                          (waveglow, ("model",))):
        a, b = make(), make()
        a.train_step({"audio": _crops(0)})
        b.load_state_dict(a.state_dict())
        for t in (a, b):
            t.train_step({"audio": _crops(1)})
        assert a.step == b.step == 2
        for name in modules:
            for p, q in zip(getattr(a, name).parameters(),
                            getattr(b, name).parameters()):
                assert torch.equal(p, q), name
    opt = a.opt
    legacy = {"state": {i: {"step": torch.tensor(float(opt.count)),
                            "exp_avg": m, "exp_avg_sq": v}
                        for i, (m, v) in enumerate(zip(opt.exp_avg,
                                                       opt.exp_avg_sq))},
              "param_groups": [{"params": list(range(len(opt.params)))}]}
    c = waveglow()
    c.opt.load_state_dict(legacy)
    assert c.opt.count == opt.count == 2
    assert all(torch.equal(x, y) for x, y in zip(
        c.opt.exp_avg + c.opt.exp_avg_sq, opt.exp_avg + opt.exp_avg_sq))
