"""The port's compiled-program counterparts on the CPU: ``stack_raw_batches``
and ``make_train_megastep`` against the JAX package's, the megastep
against the port's own sequential steps, RAdam's device-tensor scalars
against its earlier Python-float step, ``load_tts``'s seeded latent
against the generator path, and the graphed functions free of ops that
wait on the host (a CUDA graph cannot hold them). The CUDA graphs
themselves run on the card only: ``tests/test_torch_graphs_cuda.py``
(torch only, ``cuda``-marked, skipped here) and ``chip_smoke.py``'s
graphs phase at full width.

Tolerances: the JAX megastep's stacked metrics 1e-4 relative with a 1e-4
floor and its final parameters 1e-5 absolute, as
``test_torch_training.py`` holds the step (f32 on both sides in another
summation order); everything the port computes twice, bit for bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from radmmm_tpu.data import collate as jax_collate
from radmmm_tpu.data.loader import stack_raw_batches as jax_stack
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.training import optim as jax_optim
from radmmm_tpu.training import step as jax_step
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.data import collate
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.serving import export_tts, load_tts
from radmmm_torch.training import optim, step
from radmmm_torch.utils.graphs import GraphPool
from tests.test_torch_convert import perturb
from tests.test_torch_featurizer import REG, _items
from tests.test_torch_serving import TEXT_BUCKETS, FRAME_BUCKETS, _requests
from tests.test_torch_serving import ported  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401
from tests.test_tts_model import tiny_config

K = 3
FEAT = dict(filter_length=256, hop_length=64, win_length=256,
            n_mel_channels=8, f0_min=120.0, f0_max=500.0, f0_method="yin",
            mel_noise_scale=0.05)
OPT = dict(learning_rate=1e-3, weight_decay=1e-2, grad_clip_val=1.0)


def _no_dropout_config():
    cfg = tiny_config(encoder_p_dropout=0.0)
    return dataclasses.replace(cfg, **{
        k: dict(getattr(cfg, k), p_dropout=0.0)
        for k in ("f0_predictor", "energy_predictor", "voiced_predictor",
                  "duration_predictor")})


def _raws(seed: int = 5):
    """K same-shape raw batches (two utterances each, other audio and text
    in each) as both featurizers take them."""
    rng = np.random.default_rng(seed)
    feat = collate.Featurizer(device="cpu", **FEAT)
    return [feat.raw_arrays(collate.collate_host(
        _items(rng, B=2, n_text=7, seconds=(0.19, 0.16)), hop_length=64,
        audio_frames_multiple=16)) for _ in range(K)]


def _noise_table(raws, seed: int = 9):
    """The mel noise of each of the K steps, fed to both packages."""
    B, T = raws[0]["audio_i16"].shape
    return np.random.default_rng(seed).standard_normal(
        (K, B, T // FEAT["hop_length"], FEAT["n_mel_channels"])
    ).astype(np.float32)


class _FedFeaturizer(collate.Featurizer):
    """The port's featurizer with step i's noise taken from a table."""
    table = None

    def noise_key_for_step(self, step):
        return int(step)

    def mel_noise(self, raw, noise_key):
        return torch.from_numpy(self.table[noise_key])


class _JaxFedFeaturizer(jax_collate.Featurizer):
    """JAX's featurizer whose noise key is the step (traced in the scan);
    ``_fed_normal`` below maps it to the table's row."""

    def noise_key_for_step(self, step):
        return step


def _fed_normal(table):
    class Random:
        def __getattr__(self, name):
            return getattr(jax.random, name)

        @staticmethod
        def normal(key, shape):
            return jnp.asarray(table)[key].reshape(shape)

    class Jax:
        random = Random()

        def __getattr__(self, name):
            return getattr(jax, name)

    return Jax()


@pytest.fixture(scope="module")
def tiny():
    jm = JaxTTSModel(config=_no_dropout_config())
    raws = _raws()
    jfeat = jax_collate.Featurizer(**{k: v for k, v in FEAT.items()
                                      if k != "mel_noise_scale"})
    batch0 = jfeat.featurize_raw(jax.tree_util.tree_map(jnp.asarray,
                                                        raws[0]), None)
    keys = ("text", "input_lengths", "mel", "output_lengths", "speaker_ids",
            "accent_ids", "f0", "voiced_mask", "energy_avg", "attn_prior",
            "speaker_f0_mean", "speaker_f0_std")
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)},
        {k: batch0[k] for k in keys})
    return jm, perturb(v), raws


def _port(jm, v) -> TTSModel:
    port = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    return port.train()


def _seeded_models(n: int):
    """n port models of the tiny config (dropout on), alike from seed 0."""
    out = []
    for _ in range(n):
        torch.manual_seed(0)
        out.append(TTSModel(TTSConfig(**dataclasses.asdict(tiny_config()))))
    return out


def _stacked_torch(raws):
    return {k: torch.from_numpy(a) for k, a in
            step.stack_raw_batches(raws).items()}


def test_stack_raw_batches_matches_jax():
    raws = _raws()
    got, want = step.stack_raw_batches(raws), jax_stack(raws)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == (K,) + \
            raws[0][k].shape
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("phase", [(False, False), (True, True)])
def test_megastep_matches_jax(tiny, monkeypatch, phase):
    """K featurize + train steps in one call, the noise fed to both: every
    stacked metric and every parameter after."""
    jm, v, raws = tiny
    table = _noise_table(raws)
    jcfg = jax_step.LossConfig(**REG)
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats={}, spectral=v["spectral"], opt_state=tx.init(params))
    jfeat = _JaxFedFeaturizer(**FEAT)
    monkeypatch.setattr(jax_collate, "jax", _fed_normal(table))
    mega = jax.jit(jax_step.make_train_megastep(jm, jcfg, tx, jfeat, *phase))
    jstate, jmet = mega(jstate, jax_stack(raws), jax.random.key(3))

    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu", **OPT)
    feat = _FedFeaturizer(device="cpu", **FEAT)
    feat.table = table
    state, met = step.make_train_megastep(
        port, step.LossConfig(**REG), feat, *phase)(
            state, _stacked_torch(raws), torch.Generator())
    assert state.step == K and int(jstate.step) == K
    assert set(met) == set(jmet)
    for name, val in met.items():
        assert val.shape == (K,)
        np.testing.assert_allclose(val.numpy(), np.asarray(jmet[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    want = tts_state_dict_from_jax({"params": jstate.params})
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)


def test_megastep_equals_sequential_steps(tiny):
    """On the CPU the megastep is the same calls as featurize_raw with the
    step's noise key and make_train_step: bit for bit, the noise drawn
    from the featurizer's own generator, dropout on."""
    _, _, raws = tiny
    models = _seeded_models(2)
    feat = collate.Featurizer(device="cpu", seed=4, **FEAT)
    loss = step.LossConfig(**REG)

    mstate = step.create_train_state(models[0], device="cpu", **OPT)
    gen = torch.Generator().manual_seed(7)
    mstate, met = step.make_train_megastep(models[0], loss, feat, True,
                                           False)(
        mstate, _stacked_torch(raws), gen)

    sstate = step.create_train_state(models[1], device="cpu", **OPT)
    sgen = torch.Generator().manual_seed(7)
    fn = step.make_train_step(models[1], loss, True, False)
    seq = []
    for i, raw in enumerate(raws):
        batch = feat.featurize_raw({k: torch.from_numpy(a)
                                    for k, a in raw.items()},
                                   feat.noise_key_for_step(i))
        sstate, m = fn(sstate, batch, sgen)
        seq.append(m)
    assert mstate.step == sstate.step == K
    assert mstate.optimizer.count == sstate.optimizer.count == K
    for name, val in met.items():
        torch.testing.assert_close(val, torch.stack([m[name] for m in seq]),
                                   rtol=0, atol=0, msg=name)
    for (name, a), b in zip(models[0].named_parameters(),
                            models[1].parameters()):
        assert torch.equal(a, b), name
    assert torch.equal(gen.get_state(), sgen.get_state())


def _earlier_step(opt: optim.Optimizer) -> None:
    """``Optimizer.step`` as the port had it before its scalars moved into
    a device tensor: Python floats passed to the ``_foreach_*`` calls."""
    grads = opt._grads()
    norm = opt._global_norm(grads, range(len(grads)))
    params, exp_avg, exp_avg_sq = opt.params, opt.exp_avg, opt.exp_avg_sq
    if opt.clip:
        scale = torch.where(norm < opt.clip, torch.ones_like(norm),
                            opt.clip / norm)
        grads = torch._foreach_mul(grads, scale)
    opt.count += 1
    t = np.float32(opt.count)
    b1, b2 = np.float32(opt.b1), np.float32(opt.b2)
    torch._foreach_mul_(exp_avg, opt.b1)
    torch._foreach_add_(exp_avg, grads, alpha=1 - opt.b1)
    torch._foreach_mul_(exp_avg_sq, opt.b2)
    torch._foreach_addcmul_(exp_avg_sq, grads, grads, value=1 - opt.b2)
    bias1 = np.float32(1) - b1 ** t
    beta2_t = b2 ** t
    if opt.algo == "RAdam":
        n_sma_max = 2.0 / (1 - opt.b2) - 1.0
        f32 = np.float32
        n_sma = f32(n_sma_max) - f32(2) * t * beta2_t / (f32(1) - beta2_t)
        if n_sma >= 5.0:
            rect = np.sqrt((f32(1) - beta2_t) * (n_sma - f32(4))
                           / f32(n_sma_max - 4) * (n_sma - f32(2))
                           / n_sma * f32(n_sma_max) / f32(n_sma_max - 2))
            denom = torch._foreach_sqrt(exp_avg_sq)
            torch._foreach_add_(denom, opt.eps)
            delta = torch._foreach_mul(exp_avg, float(opt.lr * rect / bias1))
            torch._foreach_div_(delta, denom)
        else:
            delta = torch._foreach_mul(exp_avg, float(opt.lr / bias1))
    else:
        bias2 = np.float32(1) - beta2_t
        denom = torch._foreach_sqrt(torch._foreach_div(exp_avg_sq,
                                                       float(bias2)))
        torch._foreach_add_(denom, opt.eps)
        delta = torch._foreach_div(torch._foreach_div(exp_avg, float(bias1)),
                                   denom)
        torch._foreach_mul_(delta, opt.lr)
    if opt.wd:
        torch._foreach_add_(delta, params, alpha=opt.wd * opt.lr)
    torch._foreach_sub_(params, delta)


@pytest.mark.parametrize("algo", ["RAdam", "Adam"])
def test_device_scalars_step_is_bit_for_bit(rng, algo):
    """8 steps, gradients across the clip limit: RAdam crosses from the
    plain momentum branch (N_sma < 5, steps 1-5) to the rectified one,
    and ``prepare`` says which; every parameter and moment bit for bit
    with the Python-float step."""
    shapes = [(3, 4), (5,), (2, 3, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    new = optim.build_optimizer(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init],
        algo, **OPT)
    old = optim.build_optimizer(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init],
        algo, **OPT)
    branches = []
    for k in range(8):
        scale = 0.1 if k % 2 else 3.0
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        for opt in (new, old):
            for p, g in zip(opt.params, grads):
                p.grad = torch.from_numpy(g.copy())
        branches.append(new.prepare())
        new.apply()
        with torch.no_grad():
            _earlier_step(old)
        for a, b in zip(new.params + new.exp_avg + new.exp_avg_sq,
                        old.params + old.exp_avg + old.exp_avg_sq):
            assert torch.equal(a, b), f"step {k + 1}"
    assert branches == ([False] * 5 + [True] * 3 if algo == "RAdam"
                        else [True] * 8)
    assert new.scalars.device.type == "cpu" and new.count == 8


def test_load_tts_latent_from_the_seed_is_the_generator_path(ported, rng,
                                                             tmp_path):
    """load_tts draws the flow's latent from the request's seed and feeds
    it to stage B: the same audio, bit for bit, as infer_decode drawing
    it from a generator of that seed (sigma 0.8)."""
    *_, port, voc = ported
    path = str(tmp_path / "tts.pt")
    export_tts(port, path, vocoder=voc, sigma=0.8, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    served = load_tts(path, device="cpu")
    assert served.graphs is None
    model = port.eval().cache_inverses()
    for req in _requests(rng):
        got, lens = served(*req, 11)
        b = len(req[0])
        B, T = next((B, T) for B, T in TEXT_BUCKETS
                    if B >= b and T >= req[0].shape[1])
        text = np.zeros((B, T), np.int32)
        text[:b, :req[0].shape[1]] = req[0]
        text[b:] = text[:1]
        per = [torch.from_numpy(np.concatenate([a, np.repeat(a[:1], B - b)]))
               for a in req[1:]]
        with torch.inference_mode():
            d = model.infer_durations(torch.from_numpy(text), per[0], per[1],
                                      accent_ids=per[2])
            F = next(f for f in FRAME_BUCKETS
                     if f >= int(d["n_frames"][:b].max()))
            out = model.infer_decode(
                d["txt_enc"], d["durations"], per[1], accent_ids=per[2],
                f0_mean=per[3], f0_std=per[4], sigma=0.8, max_frames=F,
                generator=torch.Generator().manual_seed(11))
            audio = torch.round(voc(out["mel"]).clamp(-1, 1) * 32767).to(
                torch.int16)
        assert torch.equal(got, audio[:b])
        assert torch.equal(lens, out["lens"].lengths[:b])


_HOST_WAITS = {"_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique2", "unique_consecutive", "unique_dim", "equal",
               "is_nonzero", "allclose", "_linalg_check_errors"}


class _NoHostWaits(TorchDispatchMode):
    """Records every op that makes the host wait on the device's result
    (a CUDA graph cannot capture one): ``.item()``, data-dependent
    shapes, a boolean index."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name == "index" and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) if i is not None)
        if name in _HOST_WAITS or bool_index or (
                name == "repeat_interleave"
                and "output_size" not in (kwargs or {})):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


def test_graphed_functions_never_wait_on_the_device(tiny, ported, rng,
                                                    tmp_path, monkeypatch):
    """What the card captures runs no op that needs a device value on the
    host, and a warm step uploads no host array: the megastep's featurize
    + step in both phases (pYIN, MAS, CTC, the optimizer) and both serving
    stages with the vocoder; a request reads one value, between its
    stages."""
    jm, v, raws = tiny
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu", **OPT)
    feat = collate.Featurizer(device="cpu", **dict(FEAT, f0_method="pyin"))
    watch = _NoHostWaits()
    uploads = []
    from_numpy = torch.from_numpy
    with watch:
        for phase in ((False, False), (True, True)):
            mega = step.make_train_megastep(port, step.LossConfig(**REG),
                                            feat, *phase)
            stacked = _stacked_torch(raws)
            state, _ = mega(state, stacked, torch.Generator())
            # once warm, no host array becomes a tensor in the step: on the
            # card that would be a copy from pageable memory, which a
            # capture refuses
            monkeypatch.setattr(torch, "from_numpy", lambda a: uploads.append(
                a.shape) or from_numpy(a))
            state, _ = mega(state, stacked, torch.Generator())
            monkeypatch.setattr(torch, "from_numpy", from_numpy)
    assert watch.seen == [] and state.step == 4 * K and uploads == []

    *_, tts, voc = ported
    path = str(tmp_path / "tts.pt")
    export_tts(tts, path, vocoder=voc, sigma=0.8, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    served = load_tts(path, device="cpu")
    requests = _requests(rng)
    with watch:
        for req in requests:
            assert served(*req, 1)[0].dtype == torch.int16
    # one read a request: the host picks the frame bucket from stage A's
    # frame counts between the two graphs, as the JAX package does
    assert watch.seen == ["_local_scalar_dense"] * len(requests)


def test_graphed_val_step_never_waits_on_the_device(tiny):
    """The validation step the trainer graphs (binarized: the attention's
    MAS, the CTC forward and the LSTMs) runs no op that needs a device
    value on the host, on a batch featurized from raw audio; its metrics
    are finite."""
    jm, v, raws = tiny
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu", **OPT)
    feat = collate.Featurizer(device="cpu", **FEAT)
    batch = feat.featurize_raw({k: torch.from_numpy(a)
                                for k, a in raws[0].items()}, 0)
    val = step.make_val_step(port, step.LossConfig(**REG), pool=GraphPool())
    watch = _NoHostWaits()
    with watch:
        met = val(state, batch)
    assert watch.seen == []
    assert all(torch.isfinite(x) for x in met.values()) and "loss" in met
