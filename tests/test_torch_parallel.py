"""radmmm_torch.parallel (M13) against the JAX package.

* the TP rules: the port's ``param_spec`` on every parameter of the tiny
  model against JAX's on the flax path it maps from, and
  ``assert_tp_layout`` on a split tree, a replicated leaf and a tree with
  no match (as tests/test_parallel.py);
* the loader's deal: for processes 0 and 1 of 2, the port's batches
  (indices and padded shapes) against JAX's ``DataLoader(process_index,
  process_count=2)`` for two epochs, with and without shape runs and with
  the validation loader's one shape, and its simulated length;
* a training step over gloo processes, each a child with its own
  timeout and a free port, held against JAX's one-device step on the
  global batch (B 4 with ragged lengths, so the ranks hold 114 and 98 mel
  frames): data parallel (B 2 a rank), tensor parallel (n_model 2, the
  WN stack of width 1024 split, each rank the whole batch) and both (a
  2 x 2 mesh in four processes). The model is
  the tiny one with a spline step first, so the batch norms run, and the
  regularizers are on, so the batch's cross-covariance reads the gathered
  vectors. Checked: the whitening init, every loss term and the grad norm,
  every gradient, the parameters and RAdam moments after the update and
  the running statistics; the ranks' parameters bit for bit alike; the TP
  checkpoint restored in one process; a rank's shards against
  ``convert.rank_state_dict``.

Tolerances are tests/test_torch_training.py's for one process: loss terms
rtol 1e-4 with atol 1e-4, gradients rtol 1e-4 with atol 1e-5, parameters
atol 1e-5, running statistics and the whitening init rtol 1e-4 with atol
1e-5; the second moments are compared as the gradient magnitudes they
hold, sqrt(v / (1 - b2)), at the gradients' tolerances."""
import dataclasses
import functools
import os
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radmmm_tpu.data.loader import DataLoader as JaxDataLoader
from radmmm_tpu.models.tts import TTSModel as JaxTTSModel
from radmmm_tpu.parallel import mesh as jax_mesh
from radmmm_tpu.training import optim as jax_optim
from radmmm_tpu.training import step as jax_step
from radmmm_torch.convert import (_moments, _tts_leaf, rank_state_dict,
                                  tts_state_dict_from_jax)
from radmmm_torch.data.loader import DataLoader
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.parallel import mesh
from radmmm_torch.training import step
from radmmm_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_convert import perturb
from tests.test_torch_training import OPT, REG, _no_dropout_config
from tests.test_tts_model import tiny_batch
from tests.test_torch_threads import drop_tmp_path  # noqa: F401
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 240
TEXT_LENS = [7, 5, 6, 4]
MEL_LENS = [64, 50, 58, 40]


def _spline_config():
    cfg = _no_dropout_config()
    return dataclasses.replace(cfg, decoder=dict(cfg.decoder, n_splines=1,
                                                 use_bn=True))


# --- the TP rules ------------------------------------------------------

def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def tiny_params():
    jm = JaxTTSModel(config=_spline_config())
    batch = tiny_batch(np.random.default_rng(0))
    return jax.eval_shape(functools.partial(jm.init, binarize=False,
                                            train=True),
                          {"params": jax.random.key(0),
                           "dropout": jax.random.key(1)}, batch)["params"]


@pytest.mark.parametrize("n_model", [2, 3, 4])
def test_param_spec_matches_jax(tiny_params, n_model):
    """Every parameter: split by the port where JAX splits it, along the
    dim its layout maps JAX's axis to (a conv kernel's (K, C_in, C_out)
    is the port's (C_out, C_in, K)); 1024 channels do not divide by 3."""
    n_split = 0
    for path, a in _flat(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), tiny_params)):
        want = jax_mesh._norm_spec(
            jax_mesh.param_spec("/".join(path), a, n_model))
        key, value = _tts_leaf("params", path, a)
        got = mesh.param_spec(".".join(key), value.shape, n_model)
        if not want:
            assert got is None, key
            continue
        (axis,) = [i for i, n in enumerate(want) if n is not None]
        assert got == (a.ndim - 1 - axis if a.ndim == 3 else axis), key
        n_split += 1
    # the affine flow's WN: start, in_0 and res_skip_0 (v, g, bias each)
    # and end's weight; the spline step holds none
    assert n_split == (10 if n_model != 3 else 0)


def _mesh(n_model):
    return mesh.Mesh(1, n_model, rank=0, model=types.SimpleNamespace(
        size=n_model, index=0))


def test_assert_tp_layout_catches_replication():
    """A split state passes; a rule-matching leaf left whole fails; a
    tree with nothing the rules match fails."""
    torch.manual_seed(0)
    port = TTSModel(TTSConfig(**dataclasses.asdict(_spline_config())))
    state = step.create_train_state(port, device="cpu")
    m = _mesh(2)
    assert mesh.shard_state(state, m) == 10
    assert mesh.assert_tp_layout(port, m, min_sharded=10) == 10
    wn = port.decoder.flows[1].coupling.wn
    assert wn.tp is m.model
    assert wn.start.v.shape[0] == 512 and wn.end.weight.shape[1] == 512

    whole = TTSModel(TTSConfig(**dataclasses.asdict(_spline_config())))
    with pytest.raises(AssertionError, match="NOT split"):
        mesh.assert_tp_layout(whole, _mesh(2))
    with pytest.raises(AssertionError, match="silent replication"):
        mesh.assert_tp_layout(torch.nn.Linear(4, 4), _mesh(2))


# --- the loader's deal ---------------------------------------------------

class _Utterances:
    """The loader's view of a dataset: durations and encoded text lengths
    of 66 utterances, three durations and two text lengths, so batches of
    4 fall into several scheduled shapes with several batches each, and
    the last batch holds 2."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.data = [types.SimpleNamespace(duration=float(d))
                     for d in rng.choice([1.0, 2.5, 4.0], 66)]
        self.text = rng.choice([20, 40], 66)
        self.sampling_rate = 16000
        self.augmentations = None

    def encoded_text_length(self, i):
        return int(self.text[i])


def _index_batches(batches):
    return [(list(map(int, i)), None if p is None else tuple(p))
            for i, p in batches]


@pytest.mark.parametrize("shape_runs,uniform", [(0, False), (3, False),
                                                (0, True)])
def test_loader_deal_matches_jax(shape_runs, uniform):
    ds = _Utterances()
    kw = dict(batch_size=4, shuffle=not uniform, featurizer=None,
              num_threads=1, seed=5, hop_length=256,
              uniform_shape=uniform, shape_runs=shape_runs)
    epochs = []
    for r in range(2):
        loader = DataLoader(ds, process_index=r, process_count=2, **kw)
        jloader = JaxDataLoader(ds, process_index=r, process_count=2, **kw)
        assert len(loader) == len(jloader) > 0
        epochs.append([])
        for epoch in range(2):
            got = _index_batches(loader._batches())
            assert got == _index_batches(jloader._my_batches()), (r, epoch)
            n_shapes = len({p for _, p in got})
            assert n_shapes == 1 if uniform else n_shapes > 1
            epochs[r].append(got)
    for e0, e1 in zip(*epochs):
        # one round, one shape; the ranks never share an utterance
        assert [p for _, p in e0] == [p for _, p in e1]
        assert not {i for b, _ in e0 for i in b} & {i for b, _ in e1
                                                     for i in b}


def test_one_process_mesh_says_how_to_launch():
    """A mesh of more ranks than the world raises, naming both numbers and,
    in one process, how to launch under torchrun; 1 x 1 is one process."""
    assert mesh.make_mesh().shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match=r"n_data 2 x n_model 1 = 2 ranks, "
                       r"but the world has 1.*torchrun --nproc-per-node"):
        mesh.make_mesh(2, 1)
    with pytest.raises(ValueError, match="world has 1"):
        mesh.make_mesh(None, 2)


def test_loader_reads_the_mesh():
    """Without explicit indices the loader deals by the active mesh's
    data group: a 2 x 2 mesh's rank 3 is process 1 of 2."""
    m = mesh.Mesh(2, 2, rank=3)
    with mesh.use_mesh(m):
        loader = DataLoader(_Utterances(), 4, featurizer=None)
    assert (loader.process_index, loader.process_count) == (1, 2)
    assert DataLoader(_Utterances(), 4).process_count == 1


@pytest.mark.parametrize("n_proc", [2, 3])
def test_validation_deal_gives_every_rank_its_batches_at_one_shape(n_proc):
    """The validation loader as the data module builds it (no shuffle, one
    scheduled shape for the set) gives every process the same number of
    batches at the same (B, frames, text) shape, position by position, so
    the ranks' graphed validation steps warm up, capture and replay their
    collectives together; the short last batch of the set goes on no
    rank."""
    ds = _Utterances()
    shapes = []
    for r in range(n_proc):
        loader = DataLoader(ds, 4, shuffle=False, featurizer=None,
                            num_threads=1, uniform_shape=True,
                            process_index=r, process_count=n_proc)
        shapes.append([(len(i), tuple(p)) for i, p in loader._batches()])
        assert len(shapes[r]) == len(loader) == len(ds.data) // 4 // n_proc
    assert all(s == shapes[0] for s in shapes)
    assert len(set(shapes[0])) == 1 and shapes[0][0][0] == 4


def test_graph_ledger_adds_a_captured_steps_collectives_at_replay():
    """The collectives' counts tick where one is issued, so while a graph
    is captured and never while it replays. The graphs' ledger takes a
    capture's counts back and adds them at each replay, with the kernel
    launches: driven here by hand as ``StepGraph`` drives it on the card,
    ``collective_stats`` stays what the cards ran."""
    from radmmm_torch.parallel import collectives as C
    from radmmm_torch.utils import launches
    from radmmm_torch.utils.launches import launch_counts, launched
    mesh.reset_collective_stats()
    launch_counts.clear()
    C._record("all_reduce", torch.zeros(4))          # an eager step's
    launches.begin_capture()
    for _ in range(2):                                # the capture's
        C._record("all_reduce", torch.zeros(8))
    C._record("all_gather", torch.zeros(2, 3))
    launched("ctc_alpha")
    added = launches.end_capture()
    assert mesh.collective_stats() == {
        "all_reduce": {"count": 1, "bytes": 16}}
    assert launch_counts == {}
    for _ in range(3):
        launches.add_record(added)
    assert mesh.collective_stats() == {
        "all_reduce": {"count": 7, "bytes": 16 + 3 * 64},
        "all_gather": {"count": 3, "bytes": 3 * 24}}
    assert launch_counts == {"ctc_alpha": 3}
    mesh.reset_collective_stats()
    launch_counts.clear()


# --- a training step over two processes ----------------------------------

CHILD = r'''
import os, sys, torch
sys.path.insert(0, {root!r})
import torch.distributed as dist
from radmmm_torch.models.tts import TTSConfig, TTSModel
from radmmm_torch.parallel import mesh
from radmmm_torch.training import step
from radmmm_torch.utils.checkpoint import CheckpointManager

rank, inp, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
spec = torch.load(inp, weights_only=False)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        rank=rank,
                        world_size=spec["n_data"] * spec["n_model"])
m = mesh.make_mesh(spec["n_data"], spec["n_model"])
with mesh.use_mesh(m):
    model = TTSModel(TTSConfig(**spec["config"]))
    model.load_state_dict(spec["state_dict"])
    state = step.create_train_state(model, device="cpu", **spec["opt"])
    n_split = mesh.shard_state(state, m)
    if m.n_model > 1:
        mesh.assert_tp_layout(model, m, min_sharded=n_split)
    n = len(spec["batch"]["text"]) // m.n_data
    batch = {{k: v[m.data_index * n:(m.data_index + 1) * n]
             for k, v in spec["batch"].items()}}
    step.make_whitening_init(model)(state, batch)
    w = model.decoder.flows[0].invtbl_conv
    whiten = {{k: getattr(w, k).detach().clone()
              for k in ("upper", "upper_diag", "input_mean")}}
    mesh.reset_collective_stats()
    fn = step.make_train_step(model, step.LossConfig(**spec["loss"]),
                              True, True)
    state, met = fn(state, batch, torch.Generator())
    stats = mesh.collective_stats()
    opt = state.optimizer
    full = lambda d: {{k: m.gather_param(k, t).clone() for k, t in d.items()}}
    named = dict(model.named_parameters())
    out = dict(
        metrics={{k: v.item() for k, v in met.items()}}, stats=stats,
        whiten=whiten, n_split=n_split,
        grads=full({{k: p.grad for k, p in named.items()}}),
        params=full({{k: p.detach() for k, p in named.items()}}),
        exp_avg=full(dict(zip(named, opt.exp_avg))),
        exp_avg_sq=full(dict(zip(named, opt.exp_avg_sq))),
        buffers={{k: b.clone() for k, b in model.named_buffers()}},
        local={{k: p.detach().clone() for k, p in named.items()}})
    if spec.get("ckpt"):
        CheckpointManager(spec["ckpt"]).save(1, state)
torch.save(out, os.path.join(os.path.dirname(inp), f"rank{{rank}}.pt"))
dist.destroy_process_group()
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(script: str, args_of, env_of=None, n: int = 2,
              timeout: float = CHILD_TIMEOUT) -> list:
    """Start ``n`` Python children of ``script`` (``args_of(rank)`` its
    arguments, ``env_of(rank)`` extra environment), each with its own
    timeout; a child that fails or hangs fails the test and the others
    are killed. Returns their outputs."""
    procs = [subprocess.Popen(
        [sys.executable, script, *args_of(r)], cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             **(env_of(r) if env_of else {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {r} did not finish in {timeout} s")
            assert p.returncode == 0, f"rank {r}:\n{outs[-1][-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _global_batch():
    b = {k: np.asarray(a) for k, a in tiny_batch(
        np.random.default_rng(1), B=2, T_mel=64).items()}
    b2 = {k: np.asarray(a) for k, a in tiny_batch(
        np.random.default_rng(2), B=2, T_mel=64).items()}
    g = {k: np.concatenate([b[k], b2[k]]) for k in b}
    g["input_lengths"] = np.asarray(TEXT_LENS, np.int32)
    g["output_lengths"] = np.asarray(MEL_LENS, np.int32)
    g["speaker_ids"] = np.asarray([0, 2, 1, 2], np.int32)
    g["accent_ids"] = np.asarray([0, 1, 1, 0], np.int32)
    return g


@pytest.fixture(scope="module")
def reference():
    """JAX on one device over the global batch: the perturbed initial
    variables, the whitening init, the gradient at the whitened state and
    one train step (binarize and kl on)."""
    jm = JaxTTSModel(config=_spline_config())
    batch = _global_batch()
    v = jax.jit(functools.partial(jm.init, binarize=False, train=True))(
        {"params": jax.random.key(0), "dropout": jax.random.key(1)}, batch)
    v = perturb(v, seed=6)
    jcfg = jax_step.LossConfig(**REG)
    tx = jax_optim.build_optimizer("RAdam", **OPT)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    jstate = jax_step.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, buffers=v["buffers"],
        batch_stats=v["batch_stats"], spectral=v["spectral"],
        opt_state=tx.init(params))
    jstate = jax.jit(jax_step.make_whitening_init(jm))(jstate, batch)

    def loss_fn(p):
        out, _ = jm.apply(
            {"params": p, "buffers": jstate.buffers,
             "batch_stats": jstate.batch_stats, "spectral": jstate.spectral},
            batch, binarize=True, train=True,
            mutable=["batch_stats", "spectral"],
            rngs={"dropout": jax.random.key(2)})
        return jax_step.total_loss(jax_step.compute_losses(
            jm, jcfg, p, out, batch, binarization_on=True))

    grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    new, met = jax.jit(jax_step.make_train_step(jm, jcfg, tx, True, True))(
        jstate, batch, jax.random.key(0))
    np_ = functools.partial(jax.tree_util.tree_map, np.asarray)
    return dict(config=dataclasses.asdict(jm.config), v=v, batch=batch,
                whitened={"params": np_(jstate.params),
                          "buffers": np_(jstate.buffers)},
                grads=np_(grads),
                new=np_(new), metrics={k: float(x) for k, x in met.items()})


def _run_step(tmp_path, ref, n_data, n_model, ckpt=None) -> list:
    world = n_data * n_model
    inp = tmp_path / "inputs.pt"
    torch.save(dict(
        config=ref["config"], state_dict=tts_state_dict_from_jax(ref["v"]),
        batch={k: torch.from_numpy(a.copy()) for k, a in ref["batch"].items()},
        n_data=n_data, n_model=n_model, opt=OPT, loss=REG, ckpt=ckpt), inp)
    script = tmp_path / "child.py"
    script.write_text(CHILD.format(root=ROOT))
    port = str(_free_port())
    run_ranks(str(script), lambda r: [str(r), str(inp), port], n=world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _close(got: dict, want: dict, what: str, rtol=1e-4, atol=1e-5):
    assert set(got) == set(want), what
    for k, w in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def _check_against_jax(res: dict, ref: dict) -> None:
    _close(res["metrics"], ref["metrics"], "metric", atol=1e-4)
    whitened = tts_state_dict_from_jax(ref["whitened"])
    _close({k: t.numpy() for k, t in res["whiten"].items()},
           {k: whitened[f"decoder.flows.0.invtbl_conv.{k}"]
            for k in res["whiten"]}, "whitening")
    as_port = lambda tree: tts_state_dict_from_jax({"params": tree})
    _close(res["grads"], as_port(ref["grads"]), "gradient")
    _close(res["params"], as_port(ref["new"].params), "parameter",
           rtol=0)
    count, m1, m2 = _moments(ref["new"].opt_state)
    assert count == 1
    _close(res["exp_avg"], as_port(m1), "first moment")
    mag = lambda d: {k: np.sqrt(np.asarray(x) / 1e-3) for k, x in d.items()}
    _close(mag(res["exp_avg_sq"]), mag(as_port(m2)), "second moment")
    stats = tts_state_dict_from_jax({"batch_stats": ref["new"].batch_stats})
    assert stats
    _close({k: res["buffers"][k] for k in stats}, stats, "running statistic")


def _bitwise_alike(a: dict, b: dict, keys=None) -> None:
    for k in keys or a:
        assert torch.equal(a[k], b[k]), k


def test_data_parallel_step_matches_jax(reference, tmp_path):
    """Two ranks of B 2 (114 and 98 mel frames) against JAX on B 4."""
    res = _run_step(tmp_path, reference, n_data=2, n_model=1)
    for r in res:
        _check_against_jax(r, reference)
    assert res[0]["metrics"] == res[1]["metrics"]
    _bitwise_alike(res[0]["params"], res[1]["params"])
    _bitwise_alike(res[0]["buffers"], res[1]["buffers"])
    # the gradient sum is one all-reduce of every gradient's bytes
    n_bytes = sum(p.numel() * 4 for p in res[0]["grads"].values())
    ar = res[0]["stats"]["all_reduce"]
    assert ar["bytes"] >= n_bytes and "all_gather" in res[0]["stats"]


def test_tensor_parallel_step_matches_jax(reference, tmp_path):
    """n_model 2, each rank the whole B 4: the WN stack split, then the
    same comparison; the replicated parameters bit for bit alike, each
    rank's shards those of ``convert.rank_state_dict``, and the gathered
    checkpoint restored in one process."""
    ckpt = str(tmp_path / "ckpt")
    res = _run_step(tmp_path, reference, n_data=1, n_model=2, ckpt=ckpt)
    for r in res:
        _check_against_jax(r, reference)
        assert r["n_split"] == 10
    assert res[0]["metrics"] == res[1]["metrics"]
    split = {k for k, p in res[0]["local"].items()
             if p.shape != res[0]["params"][k].shape}
    assert len(split) == 10
    _bitwise_alike(res[0]["local"], res[1]["local"],
                   set(res[0]["local"]) - split)
    for r in range(2):
        want = rank_state_dict(res[r]["params"], 1, 2, r)
        _bitwise_alike(res[r]["local"], want)
    stats = res[0]["stats"]
    # one gather after start and one after in_0, a reduce-scatter each in
    # the backward, one all-reduce of end's partial products forward and
    # of the stack's input gradient backward
    assert stats["all_gather"]["count"] == 2
    assert stats["reduce_scatter"]["count"] == 2

    torch.manual_seed(0)
    port = TTSModel(TTSConfig(**reference["config"]))
    state = step.create_train_state(port, device="cpu")
    state, restored = CheckpointManager(ckpt).restore(state)
    assert restored == 1 and state.step == 1
    _bitwise_alike(dict(port.named_parameters()), res[0]["params"])


def test_data_and_tensor_parallel_step_matches_jax(reference, tmp_path):
    """A 2 x 2 mesh in four processes: ranks 0 and 1 (data index 0) take
    items 0-1, ranks 2 and 3 items 2-3, each pair splits the WN stack. The
    same comparison; every rank ends with the same gathered parameters,
    and the model groups' shards match across the data groups."""
    res = _run_step(tmp_path, reference, n_data=2, n_model=2)
    for r in res:
        _check_against_jax(r, reference)
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]
        _bitwise_alike(r["params"], res[0]["params"])
    _bitwise_alike(res[2]["local"], res[0]["local"])
    _bitwise_alike(res[3]["local"], res[1]["local"])


# --- the E2E-GAN decoder's STFT loss over two data ranks ------------------

E2E_CHILD = r'''
import os, sys, torch
sys.path.insert(0, {root!r})
import torch.distributed as dist
from radmmm_torch.losses.flow import RADTTSE2EGANLoss
from radmmm_torch.parallel import mesh
from radmmm_torch.utils.masking import SeqLens

rank, inp, port = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
spec = torch.load(inp, weights_only=False)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                        rank=rank, world_size=2)
with mesh.use_mesh(mesh.make_mesh(2, 1)):
    mine = {{k: v[2 * rank:2 * rank + 2].clone() for k, v in
            spec["batch"].items()}}
    audio_hat = mine.pop("audio_hat").requires_grad_()
    out = {{"audio_hat": audio_hat, "attn": mine["attn"],
           "attn_soft": mine["attn"], "attn_logprob": mine["attn"].log()}}
    terms = RADTTSE2EGANLoss(**spec["kw"])(
        out, mine["audio"], mine["audio_lens"],
        SeqLens.create(mine["text_lens"], mine["attn"].shape[-1]),
        SeqLens.create(mine["mel_lens"], mine["attn"].shape[-2]), True)
    sum(v * w for v, w in terms.values()).backward()
torch.save(dict(terms={{k: v.item() for k, (v, _) in terms.items()}},
                grad=audio_hat.grad),
           os.path.join(os.path.dirname(inp), f"rank{{rank}}.pt"))
dist.destroy_process_group()
'''

E2E_KW = dict(fft_lengths=(64, 128, 32), hop_lengths=(16, 32, 8),
              win_lengths=(48, 128, 32))


def test_e2e_gan_stft_loss_over_two_data_ranks(tmp_path):
    """The E2E-GAN decoder's loss on two gloo ranks of B 2 with ragged
    lengths, the global batch's longest item (256 samples) on rank 1 only,
    against JAX's ``RADTTSE2EGANLoss`` on the concatenated B 4: the ranks'
    loss terms sum to JAX's and their ``audio_hat`` gradients, put side by
    side, are JAX's gradient of the weighted sum, at rtol 1e-5 (atol 1e-7
    for the loss terms; 1e-8 for the gradient, 5e-7 of its largest entry,
    for entries near zero, where the global normaliser's other order of
    sums shows). Both put NaN at the same samples: the spectral
    convergence's sqrt of a masked frame's zero sum has no derivative
    there (ROADMAP Queue 3)."""
    from radmmm_tpu.losses import flow as JL
    from radmmm_tpu.utils.masking import SeqLens as JaxSeqLens
    rng = np.random.default_rng(11)
    T_mel, T_text = 32, 6
    attn = rng.uniform(0.01, 1, (4, T_mel, T_text)).astype(np.float32)
    attn /= attn.sum(-1, keepdims=True)
    batch = dict(
        audio=(rng.standard_normal((4, 256)) * 0.1).astype(np.float32),
        audio_hat=(rng.standard_normal((4, 256)) * 0.1).astype(np.float32),
        audio_lens=np.asarray([200, 160, 256, 120], np.float32),
        text_lens=np.asarray([6, 4, 5, 6], np.int32),
        mel_lens=np.asarray([25, 20, 32, 15], np.int32), attn=attn)

    def jax_loss(audio_hat):
        out = {"audio_hat": audio_hat, "attn": attn, "attn_soft": attn,
               "attn_logprob": jnp.log(attn)}
        terms = JL.RADTTSE2EGANLoss(**E2E_KW)(
            out, jnp.asarray(batch["audio"]), jnp.asarray(batch["audio_lens"]),
            JaxSeqLens.create(jnp.asarray(batch["text_lens"]), T_text),
            JaxSeqLens.create(jnp.asarray(batch["mel_lens"]), T_mel), True)
        return sum(v * w for v, w in terms.values()), terms

    (_, want), grad = jax.value_and_grad(jax_loss, has_aux=True)(
        jnp.asarray(batch["audio_hat"]))
    inp = tmp_path / "inputs.pt"
    torch.save(dict(batch={k: torch.from_numpy(a) for k, a in batch.items()},
                    kw=E2E_KW), inp)
    script = tmp_path / "child.py"
    script.write_text(E2E_CHILD.format(root=ROOT))
    port = str(_free_port())
    run_ranks(str(script), lambda r: [str(r), str(inp), port])
    res = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    assert set(res[0]["terms"]) == set(want)
    for k, (v, _) in want.items():
        got = res[0]["terms"][k] + res[1]["terms"][k]
        np.testing.assert_allclose(got, float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    got = torch.cat([r["grad"] for r in res]).numpy()
    np.testing.assert_allclose(got, np.asarray(grad), rtol=1e-5, atol=1e-8)
