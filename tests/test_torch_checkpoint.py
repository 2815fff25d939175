"""radmmm_torch's checkpoints against the JAX package's protocol (the
counterpart of tests/test_checkpoint.py): a save and restore round trip
bit for bit, frozen submodules left out of a save and backfilled on
restore, ``freeze_wrap`` against the JAX package's masked optimizer on
one step from the same weights, the four ``--ckpt_path`` forms, and
``load_pretrained_submodules``; on the tests' tiny config with every
dropout rate at 0 (the frameworks draw different bits). One step's
parameters within 1e-5 and its loss within rtol 1e-4 of JAX's, as
tests/test_torch_training.py holds them."""
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
from radmmm_tpu.utils import checkpoint as jax_ckpt
from radmmm_torch.convert import tts_state_dict_from_jax
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.training import step
from radmmm_torch.training.loop import Trainer, TrainerConfig
from radmmm_torch.utils.checkpoint import (CheckpointManager, freeze_wrap,
                                           frozen_param_mask,
                                           load_pretrained_submodules)
from tests.test_torch_convert import perturb
from tests.test_torch_training import _no_dropout_config
from tests.test_tts_model import tiny_batch
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

LR = 0.1


@pytest.fixture(scope="module")
def setup():
    jm = JaxTTSModel(config=_no_dropout_config())
    batch = tiny_batch(np.random.default_rng(0))
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    return jm, perturb(v), {k: np.asarray(a) for k, a in batch.items()}


def _state(jm, v):
    model = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    model.load_state_dict(tts_state_dict_from_jax(v))
    return step.create_train_state(model, device="cpu", learning_rate=LR)


def _batch(batch):
    return {k: torch.from_numpy(a.copy()) for k, a in batch.items()}


def _trained(jm, v, batch):
    """A state one step on, so the optimizer's moments are not zero."""
    state = _state(jm, v)
    fn = step.make_train_step(state.model, step.LossConfig(n_group_size=2),
                              binarize=False, kl_on=False)
    state, _ = fn(state, _batch(batch), torch.Generator())
    return state


def _snapshot(state):
    return ({k: t.clone() for k, t in state.model.state_dict().items()},
            [t.clone() for t in state.optimizer.exp_avg],
            [t.clone() for t in state.optimizer.exp_avg_sq],
            state.optimizer.count, state.step)


def _bump(state, by=1.0):
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(by)
        for m in state.optimizer.exp_avg + state.optimizer.exp_avg_sq:
            m.add_(by)
    state.step += 5
    state.optimizer.count += 5


def _equal(snap, state):
    sd, m, v, count, n = snap
    now = state.model.state_dict()
    assert set(now) == set(sd)
    for k in sd:
        assert torch.equal(now[k], sd[k]), k
    for a, b in zip(m + v, state.optimizer.exp_avg
                    + state.optimizer.exp_avg_sq):
        assert torch.equal(a, b)
    assert (count, n) == (state.optimizer.count, state.step)


def test_save_restore_roundtrip_is_exact(setup, tmp_path):
    jm, v, batch = setup
    state = _trained(jm, v, batch)
    snap = _snapshot(state)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(7, state) > 0
    assert mgr.latest_step() == 7
    _bump(state)
    restored, got = mgr.restore(state)
    assert got == 7
    _equal(snap, restored)


def test_max_to_keep_drops_the_oldest(setup, tmp_path):
    jm, v, batch = setup
    state = _state(jm, v)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    for n in (3, 6, 9):
        mgr.save(n, state)
    assert mgr.steps() == [6, 9]


def test_exclude_and_backfill(setup, tmp_path):
    """Frozen submodules are left out of a save and keep their live values
    on restore (tts_lightning_modules.py:514-540), as in the JAX
    package."""
    jm, v, batch = setup
    state = _trained(jm, v, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, state, exclude_prefixes=["decoder"])
    saved = {k: t.clone() for k, t in state.model.state_dict().items()}
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            p.mul_(2.0 if name.startswith("decoder.") else 3.0)
    live = {k: t.clone() for k, t in state.model.state_dict().items()}
    restored, _ = mgr.restore(state)
    for k, t in restored.model.state_dict().items():
        want = live[k] if k.startswith("decoder.") else saved[k]
        assert torch.equal(t, want), k


def test_freeze_matches_jax(setup):
    """One step with the decoder frozen: it stays exactly, its moments stay
    zero, and every other parameter, the loss and the grad norm (of all
    gradients) match the JAX package's masked optimizer."""
    jm, v, batch = setup
    tx = jax_optim.build_optimizer("RAdam", learning_rate=LR)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    ftx = jax_ckpt.freeze_wrap(tx, params, ["decoder"])
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats={}, spectral=v["spectral"], opt_state=ftx.init(params))
    cfg = dict(n_group_size=2)
    jstate, jmet = jax.jit(jax_step.make_train_step(
        jm, jax_step.LossConfig(**cfg), ftx, binarize=False, kl_on=False))(
            jstate, batch, jax.random.key(1))

    state = _state(jm, v)
    before = {k: t.clone() for k, t in state.model.state_dict().items()}
    freeze_wrap(state.optimizer, state.model, ["decoder"])
    mask = frozen_param_mask(state.model, ["decoder"])
    assert all(mask[n] == n.startswith("decoder.") for n in mask)
    state, met = step.make_train_step(
        state.model, step.LossConfig(**cfg), binarize=False, kl_on=False)(
            state, _batch(batch), torch.Generator())
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(met[name].item(), float(jmet[name]),
                                   rtol=1e-4, err_msg=name)
    want = tts_state_dict_from_jax({"params": jstate.params})
    for name, p in state.model.named_parameters():
        if mask[name]:
            assert torch.equal(p, before[name]), name
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=1e-5, err_msg=name)
    moved = [n for n, p in state.model.named_parameters()
             if not torch.equal(p, before[n])]
    assert moved and not any(mask[n] for n in moved)
    names = [n for n, _ in state.model.named_parameters()]
    for n, m1, m2 in zip(names, state.optimizer.exp_avg,
                         state.optimizer.exp_avg_sq):
        if mask[n]:
            assert not m1.any() and not m2.any(), n


def test_ckpt_path_forms(setup, tmp_path):
    """--ckpt_path: an integer step of this run, another run's directory,
    a step directory and a ckpt directory; a missing path or checkpoint
    fails loudly."""
    jm, v, batch = setup
    state = _state(jm, v)
    run = tmp_path / "runA"
    mgr = CheckpointManager(str(run / "ckpt"))
    first = _snapshot(state)
    mgr.save(2, state)
    _bump(state)
    second = _snapshot(state)
    mgr.save(5, state)

    config = TTSConfig(**dataclasses.asdict(jm.config))

    def restored(ckpt_path, outdir):
        tr = Trainer(config, step.LossConfig(),
                     TrainerConfig(output_directory=str(outdir),
                                   ckpt_path=ckpt_path, device="cpu"))
        _bump(state, 7.0)
        return tr._restore_state(state)

    for ckpt_path, outdir, want_step, want in (
            (None, run, 5, second), ("2", run, 2, first),
            (str(run), tmp_path / "runB", 5, second),
            (str(run / "ckpt" / "2"), tmp_path / "runC", 2, first),
            (str(run / "ckpt"), tmp_path / "runD", 5, second)):
        got, n = restored(ckpt_path, outdir)
        assert n == want_step, ckpt_path
        _equal(want, got)
    with pytest.raises(FileNotFoundError):
        Trainer(config, step.LossConfig(), TrainerConfig(
            output_directory=str(tmp_path / "runE"), device="cpu")
        )._restore_state(state, require=True)
    with pytest.raises(FileNotFoundError):
        restored(str(tmp_path / "nope"), tmp_path / "runF")


def test_load_pretrained_submodules(setup, tmp_path):
    """Named submodules come from another run's step directory; the rest
    keep their own values."""
    jm, v, batch = setup
    donor = _trained(jm, v, batch)
    CheckpointManager(str(tmp_path / "donor" / "ckpt")).save(4, donor)
    state = _state(jm, v)
    mine = {k: t.clone() for k, t in state.model.state_dict().items()}
    load_pretrained_submodules(state.model,
                               str(tmp_path / "donor" / "ckpt" / "4"),
                               ["decoder", "text_encoder"])
    theirs = donor.model.state_dict()
    for k, t in state.model.state_dict().items():
        from_donor = k.split(".")[0] in ("decoder", "text_encoder")
        assert torch.equal(t, theirs[k] if from_donor else mine[k]), k


def test_batch_norm_running_statistics_round_trip(tmp_path):
    """A model with a spline flow step: its batch norms' running
    statistics, moved by two training steps, go into the checkpoint and
    come back on restore into a fresh state; the resumed step then moves
    them from there exactly as the uninterrupted run does."""
    from tests.test_torch_training import _spline_setup
    jm, v, batch = _spline_setup()

    def bn_buffers(model):
        return {k: t.clone() for k, t in model.state_dict().items()
                if k.endswith(".bn.mean") or k.endswith(".bn.var")}

    state = _state(jm, v)
    fn = step.make_train_step(state.model, step.LossConfig(n_group_size=2),
                              binarize=False, kl_on=False)
    start = bn_buffers(state.model)
    assert start
    for _ in range(2):
        state, _ = fn(state, _batch(batch), torch.Generator())
    moved = bn_buffers(state.model)
    assert all(not torch.equal(moved[k], start[k]) for k in start)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)

    fresh = _state(jm, v)
    fresh, step_ = mgr.restore(fresh)
    assert step_ == 2
    for k, t in bn_buffers(fresh.model).items():
        assert torch.equal(t, moved[k]), k
    state, _ = fn(state, _batch(batch), torch.Generator())
    fn2 = step.make_train_step(fresh.model, step.LossConfig(n_group_size=2),
                               binarize=False, kl_on=False)
    fresh, _ = fn2(fresh, _batch(batch), torch.Generator())
    want = bn_buffers(state.model)
    for k, t in bn_buffers(fresh.model).items():
        assert torch.equal(t, want[k]), k
