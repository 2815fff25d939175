"""radmmm_torch training slice against the JAX package at the tests' tiny
config with every dropout rate at 0 (the two frameworks draw different
random bits): the training forward, every loss term and one step's full
gradient tree, the exact RAdam, an 8-step trajectory through both phases,
the validation step and the whitening init; and the port's own repairs:
sampling after a step uses the new weights' inverses, and on the CPU no
kernel launches.

Tolerances: forward outputs and loss terms 1e-4 absolute (f32 on both
sides, summation order through the encoder, the attention and two flow
steps); gradients 1e-4 relative with a 1e-5 floor (the same, through the
backward); the optimizer 1e-7 relative (the same float32 arithmetic);
after 8 steps the parameters 1e-5 absolute (steps of lr 1e-3 carry each
step's rounding forward)."""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.training import optim as jax_optim
from radmmm_tpu.training import step as jax_step
from radmmm_torch.convert import load_jax_train_state, tts_state_dict_from_jax
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.training import optim, step
from radmmm_torch.utils import graphs
from radmmm_torch.utils.launches import launch_counts
from tests.test_torch_convert import perturb
from tests.test_tts_model import tiny_batch, tiny_config
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
REG = dict(cross_covariance_weight=1.0,
           speaker_reg={"variance": 1.0, "covariance": 1.0},
           accent_reg={"variance": 0.5, "covariance": 0.5})
OPT = dict(learning_rate=1e-3, weight_decay=1e-2, grad_clip_val=1.0)


def _no_dropout_config():
    cfg = tiny_config(encoder_p_dropout=0.0)
    return dataclasses.replace(cfg, **{
        k: dict(getattr(cfg, k), p_dropout=0.0)
        for k in ("f0_predictor", "energy_predictor", "voiced_predictor",
                  "duration_predictor")})


@pytest.fixture(scope="module")
def setup():
    jm = JaxTTSModel(config=_no_dropout_config())
    batch = tiny_batch(np.random.default_rng(0))
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    return jm, perturb(v), {k: np.asarray(a) for k, a in batch.items()}


def _port(jm, v) -> TTSModel:
    port = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    return port.train()


def _t(batch):
    return {k: torch.from_numpy(a.copy()) for k, a in batch.items()}


def _params(v):
    return jax.tree_util.tree_map(jnp.asarray, v["params"])


def _close(got, want, what, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               err_msg=what)


def _grads_close(port, g_tree):
    want = tts_state_dict_from_jax({"params": g_tree})
    for name, p in port.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def _spectral_close(port, spectral):
    for k, u in tts_state_dict_from_jax({"spectral": spectral}).items():
        _close(port.get_buffer(k).numpy(), u.numpy(), k, atol=1e-5)


def test_forward_losses_and_gradients_match_jax(setup):
    """binarize and kl on: the hard MAS alignment, the CTC loss, the
    binarization loss and the regularizers all in the loss."""
    jm, v, batch = setup
    jcfg = jax_step.LossConfig(**REG)

    def loss_fn(params):
        out, mut = jm.apply(
            {"params": params, "buffers": v["buffers"],
             "spectral": v["spectral"]}, batch, binarize=True, train=True,
            mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.key(2)})
        ld = jax_step.compute_losses(jm, jcfg, params, out, batch,
                                     binarization_on=True)
        return jax_step.total_loss(ld), (ld, out, mut)

    (_, (jld, jout, mut)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(_params(v))

    port = _port(jm, v)
    tb = _t(batch)
    out = port(tb, binarize=True, train=True)
    ld = step.compute_losses(port, step.LossConfig(**REG), out, tb, True)
    assert set(ld) == set(jld)
    for k, (val, w) in ld.items():
        _close(val.item(), jld[k][0], k)
        assert w == jld[k][1], k
    for k in ("z_mel", "attn", "attn_soft", "attn_logprob", "context",
              "txt_enc"):
        _close(out[k].detach(), jout[k], k)
    for k in ("log_s_list", "log_det_W_list"):
        assert len(out[k]) == len(jout[k])
        for i, (a, b) in enumerate(zip(out[k], jout[k])):
            _close(a.detach(), b, f"{k}[{i}]")
    for k in ("f0_outputs", "energy_outputs", "voiced_outputs",
              "duration_outputs"):
        for kk in ("x_hat", "x"):
            _close(out[k][kk].detach(), jout[k][kk], f"{k}.{kk}")
    assert np.asarray(jout["attn"]).sum() > 0      # a hard alignment
    step.total_loss(ld).backward()
    _grads_close(port, g)
    _spectral_close(port, mut["spectral"])


@pytest.mark.parametrize("algo", ["RAdam", "Adam"])
def test_optimizer_matches_jax(rng, algo):
    """8 steps on two tensors, gradients scaled across the clip limit; the
    first RAdam steps take the plain SGD branch (N_sma < 5)."""
    shapes = [(3, 4), (5,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_optim.build_optimizer(algo, **OPT)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.build_optimizer(tp, algo, **OPT)
    for k in range(8):
        scale = 0.1 if k % 2 else 3.0          # below / above the clip
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        upd, state = tx.update([jnp.asarray(g) for g in grads], state, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        for p, g in zip(tp, grads):
            p.grad = torch.from_numpy(g)
        norm = opt.step()
        np.testing.assert_allclose(
            norm.item(), np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                     for g in grads)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {k}")


def _jax_state(jm, v, tx):
    params = _params(v)
    return jax_step.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                               buffers=v["buffers"], batch_stats={},
                               spectral=v["spectral"],
                               opt_state=tx.init(params))


def test_trajectory_of_8_steps_in_both_phases(setup):
    """4 steps with binarize and kl off, then 4 with both on: every loss
    term and the grad norm at each step, then every parameter and
    spectral u."""
    jm, v, batch = setup
    jcfg = jax_step.LossConfig(**REG)
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    jstate = _jax_state(jm, v, tx)
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu", **OPT)
    tb = _t(batch)
    gen = torch.Generator()
    for phase in ((False, False), (True, True)):
        jfn = jax.jit(jax_step.make_train_step(jm, jcfg, tx, *phase))
        fn = step.make_train_step(port, step.LossConfig(**REG), *phase)
        for k in range(4):
            jstate, jmet = jfn(jstate, batch, jax.random.key(k))
            state, met = fn(state, tb, gen)
            assert set(met) == set(jmet)
            for name, val in met.items():
                np.testing.assert_allclose(
                    val.item(), float(jmet[name]), rtol=1e-4, atol=ATOL,
                    err_msg=f"{phase} step {k}: {name}")
    assert state.step == 8 and int(jstate.step) == 8
    want = tts_state_dict_from_jax({"params": jstate.params})
    for name, p in port.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), name, atol=1e-5)
    _spectral_close(port, jstate.spectral)

    # a second port model resumes from the JAX state: step 9 on both
    resumed = step.create_train_state(_port(jm, v), device="cpu", **OPT)
    load_jax_train_state(resumed, jax.tree_util.tree_map(np.asarray, jstate))
    assert resumed.step == 8 and resumed.optimizer.count == 8
    jstate, jmet = jfn(jstate, batch, jax.random.key(8))
    resumed, met = step.make_train_step(resumed.model, step.LossConfig(**REG),
                                        True, True)(resumed, tb, gen)
    np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]),
                               rtol=1e-4, atol=ATOL)
    want = tts_state_dict_from_jax({"params": jstate.params})
    for name, p in resumed.model.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), name, atol=1e-5)


@pytest.mark.parametrize("graphed", [False, True])
def test_val_step_matches_jax(setup, monkeypatch, graphed):
    """The validation step, eager or through ``Graphed`` in a pool (as the
    trainer runs it; eager on the CPU), against JAX's jitted one on the
    same weights; it updates no spectral norm."""
    jm, v, batch = setup
    jcfg = jax_step.LossConfig(**REG)
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    want = jax.jit(jax_step.make_val_step(jm, jcfg))(
        _jax_state(jm, v, tx), batch)
    port = _port(jm, v)
    u = port.text_encoder.lstm.sn_fwd.u.clone()
    state = step.create_train_state(port, device="cpu")
    names = []
    call = graphs.Graphed.__call__
    monkeypatch.setattr(graphs.Graphed, "__call__", lambda self, x, key=(): (
        names.append(self.name) or call(self, x, key)))
    val_step = step.make_val_step(
        port, step.LossConfig(**REG),
        pool=graphs.GraphPool() if graphed else None)
    got = val_step(state, dict(_t(batch), audiopaths=["a.wav"] * 2))
    assert names == (["val_step"] if graphed else [])
    assert set(got) == set(want)
    for name, val in got.items():
        _close(val.item(), want[name], name)
    assert torch.equal(port.text_encoder.lstm.sn_fwd.u, u)


def test_whitening_init_matches_jax(setup):
    """Mean, and the upper Cholesky factor of the inverse covariance of
    the batch's squeezed mel frames, on 61 valid frames of 16 channels (a
    full-rank covariance). The factor 1e-4 relative: JAX takes inverse
    and Cholesky in f32, the port in float64."""
    jm, v, _ = setup
    batch = {k: np.asarray(a) for k, a in tiny_batch(
        np.random.default_rng(1), T_mel=64).items()}
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    jstate = jax.jit(jax_step.make_whitening_init(jm))(
        _jax_state(jm, v, tx), batch)
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu")
    step.make_whitening_init(port)(state, _t(batch))
    w = port.decoder.flows[0].invtbl_conv
    jp = jstate.params["decoder"]["flow_0"]["invtbl_conv"]
    jb = jstate.buffers["decoder"]["flow_0"]["invtbl_conv"]
    _close(w.input_mean.numpy(), jb["input_mean"], "input_mean", atol=1e-6)
    for k in ("upper", "upper_diag"):
        np.testing.assert_allclose(getattr(w, k).detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert bool(w.initialized)


def test_infer_after_a_step_uses_fresh_inverses(setup):
    """A model with cached 1x1 inverses takes a training step; sampling
    afterwards equals sampling from a copy whose inverses are computed
    afresh from the new weights, and differs from sampling with the
    inverses cached before the step."""
    jm, v, batch = setup
    port = _port(jm, v).eval().cache_inverses()
    inv = [m for m in port.modules() if hasattr(m, "w_inv")]
    stale = [m.w_inv.clone() for m in inv]
    state = step.create_train_state(port, device="cpu", **OPT)
    assert all(m.w_inv is None for m in inv)                  # train()
    port.eval().cache_inverses()
    fn = step.make_train_step(port, step.LossConfig(), False, False)
    fn(state, _t(batch), torch.Generator())
    assert all(m.w_inv is None for m in inv)
    port.eval()
    fresh = copy.deepcopy(port).cache_inverses()
    tb = _t(batch)
    args = (tb["text"], tb["input_lengths"], tb["speaker_ids"])
    kw = dict(accent_ids=tb["accent_ids"], sigma=0.0, max_frames=24)
    with torch.inference_mode():
        got, want = port.infer(*args, **kw), fresh.infer(*args, **kw)
        for m, w in zip(inv, stale):
            m.w_inv = w
        old = port.infer(*args, **kw)
    assert torch.equal(got["mel"], want["mel"])
    # one step at lr 1e-3 moves the stale mel by about 2e-5 (max 5.3)
    assert (old["mel"] - want["mel"]).abs().max() > 1e-6


def test_training_on_cpu_launches_no_kernel(setup):
    jm, v, batch = setup
    launch_counts.clear()
    port = _port(jm, v)
    state = step.create_train_state(port, device="cpu")
    step.make_train_step(port, step.LossConfig(), True, True)(
        state, _t(batch), torch.Generator())
    assert not launch_counts


def test_dropout_draws_from_the_generator(setup):
    """With dropout on, two steps' forwards from generators of one seed
    agree, and another seed gives other outputs."""
    jm, v, batch = setup
    cfg = dataclasses.replace(TTSConfig(**dataclasses.asdict(jm.config)),
                              encoder_p_dropout=0.5)
    tb = _t(batch)
    outs = []
    for seed in (1, 1, 2):
        # a model each: a training forward also moves the spectral norms' u
        port = TTSModel(cfg)
        port.load_state_dict(tts_state_dict_from_jax(v))
        with torch.no_grad():
            outs.append(port(tb, train=True,
                             generator=torch.Generator().manual_seed(seed))
                        ["txt_enc"])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_phase_flags_match_jax():
    for s in (0, 19999, 20000, 25000, 25001):
        assert step.phase_flags(s, step.LossConfig()) == \
            jax_step.phase_flags(s, jax_step.LossConfig())


def _spline_setup():
    """The tiny model with a spline flow step first (2 flows; flow 0 holds
    the whitening 1x1 and a quadratic spline coupling with batch norms),
    dropout at 0."""
    cfg = _no_dropout_config()
    cfg = dataclasses.replace(cfg, decoder=dict(cfg.decoder, n_splines=1,
                                                use_bn=True))
    jm = JaxTTSModel(config=cfg)
    # 64 frames: the whitening init needs a full-rank covariance (61
    # valid frames of 16 channels)
    batch = tiny_batch(np.random.default_rng(1), T_mel=64)
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    assert v["batch_stats"]
    return jm, perturb(v, seed=6), {k: np.asarray(a)
                                    for k, a in batch.items()}


def _batch_stats_close(port, batch_stats):
    stats = tts_state_dict_from_jax({"batch_stats": batch_stats})
    assert stats and all(k.endswith((".mean", ".var")) for k in stats)
    for k, want in stats.items():
        np.testing.assert_allclose(port.get_buffer(k).numpy(),
                                   want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_spline_flow_training_steps_match_jax():
    """3 training steps (binarize and kl on) of the model with a spline
    step, then the validation step: every loss term, the grad norm and
    the gradients of the first step, the parameters and the batch norms'
    running statistics after the steps (each step moves them, as JAX's
    mutable batch_stats does), and the validation step on the running
    statistics. The whitening init leaves the spline coupling alone and
    matches JAX's; a port state loaded from the JAX state carries the
    running statistics over."""
    jm, v, batch = _spline_setup()
    jcfg = jax_step.LossConfig(**REG)
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    params = _params(v)
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats=v["batch_stats"], spectral=v["spectral"],
        opt_state=tx.init(params))
    port = _port(jm, v)
    assert type(port.decoder.flows[0].coupling).__name__ == "SplineCoupling"
    state = step.create_train_state(port, device="cpu", **OPT)
    tb = _t(batch)
    jstate = jax.jit(jax_step.make_whitening_init(jm))(jstate, batch)
    step.make_whitening_init(port)(state, tb)
    jp = jstate.params["decoder"]["flow_0"]["invtbl_conv"]
    np.testing.assert_allclose(
        port.decoder.flows[0].invtbl_conv.upper.detach().numpy(),
        np.asarray(jp["upper"]), rtol=1e-4, atol=1e-5)
    before = copy.deepcopy(port.decoder.flows[0].coupling.state_dict())
    for k, t in port.decoder.flows[0].coupling.state_dict().items():
        assert torch.equal(t, before[k])

    jfn = jax.jit(jax_step.make_train_step(jm, jcfg, tx, True, True))
    fn = step.make_train_step(port, step.LossConfig(**REG), True, True)
    gen = torch.Generator()
    for k in range(3):
        jstate, jmet = jfn(jstate, batch, jax.random.key(k))
        state, met = fn(state, tb, gen)
        assert set(met) == set(jmet)
        for name, val in met.items():
            np.testing.assert_allclose(val.item(), float(jmet[name]),
                                       rtol=1e-4, atol=ATOL,
                                       err_msg=f"step {k}: {name}")
        _batch_stats_close(port, jstate.batch_stats)
    want = tts_state_dict_from_jax({"params": jstate.params})
    for name, p in port.named_parameters():
        _close(p.detach().numpy(), want[name].numpy(), name, atol=1e-5)

    jval = jax.jit(jax_step.make_val_step(jm, jcfg))(jstate, batch)
    val = step.make_val_step(port, step.LossConfig(**REG))(state, tb)
    for name, x in val.items():
        _close(x.item(), jval[name], f"val {name}")
    _batch_stats_close(port, jstate.batch_stats)     # eval moves nothing

    resumed = step.create_train_state(_port(jm, v), device="cpu", **OPT)
    load_jax_train_state(resumed, jax.tree_util.tree_map(np.asarray, jstate))
    _batch_stats_close(resumed.model, jstate.batch_stats)


def test_spline_flow_first_step_gradients_match_jax():
    """One step's full gradient tree through the spline coupling, its FiLM
    stack and batch norms, in training mode."""
    jm, v, batch = _spline_setup()
    jcfg = jax_step.LossConfig(**REG)

    def loss_fn(params):
        out, mut = jm.apply(
            {"params": params, "buffers": v["buffers"],
             "batch_stats": v["batch_stats"], "spectral": v["spectral"]},
            batch, binarize=True, train=True,
            mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.key(2)})
        ld = jax_step.compute_losses(jm, jcfg, params, out, batch,
                                     binarization_on=True)
        return jax_step.total_loss(ld), mut

    (_, mut), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _params(v))
    port = _port(jm, v)
    tb = _t(batch)
    out = port(tb, binarize=True, train=True)
    step.total_loss(step.compute_losses(port, step.LossConfig(**REG), out,
                                        tb, True)).backward()
    _grads_close(port, g)
    _batch_stats_close(port, mut["batch_stats"])
