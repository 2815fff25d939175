"""Process meshes and the tensor-parallel layout for training on several
cards.

Counterpart of ``radmmm_tpu/parallel/mesh.py``. PyTorch runs one process
per card, so where the JAX package lays devices out on a
``jax.sharding.Mesh`` this module lays out ranks: ``make_mesh(n_data,
n_model)`` puts the world's ranks on a row-major (n_data, n_model) grid,
with a ``data`` group along each column (ranks that hold other batches
and the same parameters) and a ``model`` group along each row (ranks that
hold one batch and split the flow's WN stacks between them).

The JAX step is one SPMD program over the global batch, so it computes
what one device would compute on the concatenated batch. The port keeps
that meaning with per-rank data: each rank's loss is its share of the
global loss (sums over its items over the global normalisers), batch
statistics and the whitening init's moments are summed over the data
group, and the gradients are summed over it (``sync_grads``), which
makes them the gradient of the global loss. The losses and norms read the
mesh set by ``set_mesh``/``use_mesh`` through ``data_sum``,
``data_max``, ``data_all_reduce`` and ``data_gather``; with no mesh (one
process) these are the identity.

The TP rules (``_TP_RULES``) are the JAX package's, on the port's names
and layouts: the WN ``start``, ``in_i`` and ``res_skip_i`` convs are split
along their output channels (weight-norm ``g`` and the bias with them),
``end`` along its input channels. ``shard_state`` cuts a full state to a
rank's shards, ``gather_param`` rebuilds a full tensor for a checkpoint,
``assert_tp_layout`` fails when a parameter the rules match is not split.

    dev = init_distributed("cuda")          # under torchrun
    mesh = make_mesh(n_data=None, n_model=2)
    with use_mesh(mesh):
        shard_state(state, mesh)
        state, metrics = step(state, batch, generator)
"""
from __future__ import annotations

import contextlib
import os
import re
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from radmmm_torch.parallel import collectives as C
from radmmm_torch.utils import graphs
from radmmm_torch.utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
LAUNCH = ("torchrun --nproc-per-node N -m radmmm_torch.training.cli fit "
          "--distributed -c ...")
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def init_distributed(device: str = "cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group torchrun describes in the environment and
    return this process's device: ``cuda:LOCAL_RANK`` under NCCL (one card
    a rank), the card ``LOCAL_RANK`` modulo the count under gloo (ranks may
    share a card), the CPU under gloo for ``device="cpu"``. ``backend``
    defaults to NCCL on the card and gloo on the CPU."""
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed reads torchrun's environment, and "
            f"{', '.join(missing)} is not set: launch with `{LAUNCH}`")
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > n_cards:
            raise RuntimeError(
                f"{local_world} ranks on this host and {n_cards} card(s): "
                "NCCL takes one card a rank (pass --dist-backend gloo to "
                "share cards)")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r} on the CPU: only gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    return dev


class Mesh:
    """This rank's place on the (n_data, n_model) grid: ``data`` and
    ``model`` (``collectives.Group``s), the global ``rank`` and, per
    sharded parameter name, the (dim, full shape) ``shard_state`` cut
    (``layout``)."""

    def __init__(self, n_data: int, n_model: int, rank: int = 0,
                 data: Optional[C.Group] = None,
                 model: Optional[C.Group] = None,
                 model_ranks: Tuple[int, ...] = (0,)):
        self.n_data, self.n_model, self.rank = n_data, n_model, rank
        self.data = data or C.Group(None, 1, 0, "gloo")
        self.model = model or C.Group(None, 1, 0, "gloo")
        self.model_ranks = model_ranks
        self.layout: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        # set ``timed`` to time the gradients' all-reduces (it synchronises
        # the card around them): (ms, bytes) of the last ``sync_grads``
        self.timed = False
        self.last_grad_sync: Tuple[float, int] = (0.0, 0)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can hold this rank's collectives: in one
        process, or over NCCL. gloo's cannot be captured: its CUDA tensors
        go through host memory."""
        return all(g.nccl for g in (self.data, self.model) if g.size > 1)

    def barrier(self) -> None:
        if self.n_data * self.n_model > 1:
            dist.barrier()

    def sync_grads(self, optimizer) -> None:
        """Sum every parameter's gradient over the data group (a missing
        gradient counts as zero), which makes it the gradient of the
        global loss, and average the replicated parameters' gradients over
        the model group: each rank of a model group computes them whole,
        and averaging keeps them alike to the bit where a card's backward
        sums in another order on each rank. Flat buckets of up to 2^26
        elements. A ``timed`` mesh synchronises the card around them,
        which a CUDA graph cannot capture: it raises there."""
        if self.data.size == 1 and self.model.size == 1:
            return
        params = optimizer.params
        if (self.timed and params[0].is_cuda
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(
                "a timed mesh synchronises the card around the gradients' "
                "all-reduces and cannot be captured in a CUDA graph: run "
                "its steps eager")
        grads = []
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        if self.timed:
            _sync(params[0].device)
            t0 = time.perf_counter()
        n_bytes = 0
        if self.data.size > 1:
            n_bytes += _all_reduce_flat(grads, self.data)
        if self.model.size > 1:
            whole = [g for g, s in zip(grads, optimizer.sharded) if not s]
            n_bytes += _all_reduce_flat(whole, self.model)
            torch._foreach_div_(whole, float(self.model.size))
        if self.timed:
            _sync(params[0].device)
            self.last_grad_sync = ((time.perf_counter() - t0) * 1e3, n_bytes)

    def broadcast_batch(self, batch: dict) -> dict:
        """The batch of the model group's first rank on every rank of the
        group (its ranks load the same batch, but augmentations drawn by
        several loader threads may differ). Each tensor goes as its bytes:
        neither NCCL nor gloo takes int16 (the raw batch's audio)."""
        if self.model.size == 1:
            return batch
        out = dict(batch)
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.contiguous()
                C._record("broadcast", out[k])
                dist.broadcast(out[k].reshape(-1).view(torch.uint8),
                               src=self.model_ranks[0],
                               group=self.model.group)
        return out

    def gather_param(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full tensor of parameter (or moment) ``name`` from this
        rank's shard ``t``: gathered over the model group where
        ``shard_state`` cut it, ``t`` itself elsewhere."""
        if name not in self.layout:
            return t
        return C.gather_along(t.detach(), self.model, self.layout[name][0])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        graphs.synchronize(device)


def _all_reduce_flat(tensors, g: C.Group) -> int:
    """Sum ``tensors`` over ``g`` in place, through flat buckets; returns
    the bytes reduced."""
    n_bytes = 0
    for bucket in _buckets(tensors, 1 << 26):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        C.all_reduce_(flat, g)
        n_bytes += flat.numel() * flat.element_size()
        torch._foreach_copy_(bucket, [
            f.view_as(t) for f, t in zip(
                flat.split([t.numel() for t in bucket]), bucket)])
    return n_bytes


def _buckets(tensors, limit: int):
    """Consecutive runs of ``tensors`` of at most ``limit`` elements (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        if bucket and size + t.numel() > limit:
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += t.numel()
    if bucket:
        yield bucket


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) grid over the world's ranks, row-major (rank
    r at data index r // n_model, model index r % n_model), with its
    groups; ``n_data`` defaults to world // n_model. Without an initialised
    process group the world is this one process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_model = max(1, int(n_model))
    n_data = world // n_model if n_data is None else int(n_data)
    if n_data * n_model != world:
        hint = (f"; launch {n_data * n_model} processes with `{LAUNCH}`"
                if world == 1 else "")
        raise ValueError(
            f"n_data {n_data} x n_model {n_model} = {n_data * n_model} "
            f"ranks, but the world has {world}{hint}")
    if world == 1:
        return Mesh(1, 1)
    backend = dist.get_backend()
    d, m = divmod(rank, n_model)
    groups = {}
    # every rank creates every group, in one order
    for axis, members in (
            ("model", [[i * n_model + j for j in range(n_model)]
                       for i in range(n_data)]),
            ("data", [[i * n_model + j for i in range(n_data)]
                      for j in range(n_model)])):
        for ranks in members:
            if len(ranks) == 1:
                continue
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = (C.Group(g, len(ranks), ranks.index(rank),
                                        backend), tuple(ranks))
    data = groups.get("data", (None, None))[0]
    model, model_ranks = groups.get("model", (None, (rank,)))
    return Mesh(n_data, n_model, rank, data, model, model_ranks)


_MESH: Optional[Mesh] = None


def get_mesh() -> Mesh:
    """The active mesh; a one-process mesh when none is set."""
    return _MESH if _MESH is not None else Mesh(1, 1)


def set_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Make ``mesh`` active; returns the one it replaces."""
    global _MESH
    prev, _MESH = _MESH, mesh
    return prev


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    prev = set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


# --- the global batch's sums, for the losses and the batch statistics ---

def n_data() -> int:
    return get_mesh().n_data


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, no gradient (a normaliser: a
    count of frames or items)."""
    g = get_mesh().data
    return x if g.size == 1 else C.all_reduce_(C.fresh(x.detach()), g)


def data_max(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elementwise max over the data group, no gradient (the
    global batch's longest item)."""
    g = get_mesh().data
    return x if g.size == 1 else C.all_reduce_max_(C.fresh(x.detach()), g)


def data_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group, with its gradient (a batch
    statistic every rank's share of the loss reads)."""
    return C.all_reduce_sum(x, get_mesh().data)


def data_gather(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` concatenated along the batch, with its
    gradient (for a loss that is not a sum over items)."""
    return C.gather(x, get_mesh().data, 0)


# --- the tensor-parallel layout ---

# (name pattern, the dim split over the model group): the JAX package's
# rules on the port's names and (C_out, C_in, K) layouts
_TP_RULES = [
    (re.compile(r"flows\.\d+\.coupling\.wn\.(start|in_\d+|res_skip_\d+)\."
                r"(v|weight|g|bias)$"), 0),
    (re.compile(r"flows\.\d+\.coupling\.wn\.end\.(v|weight)$"), 1),
]


def param_spec(name: str, shape, n_model: int) -> Optional[int]:
    """The dim of parameter ``name`` (of its full ``shape``) split over the
    model group, or None where it is replicated: no rule matches, the dim
    does not divide by ``n_model``, or ``n_model`` is 1."""
    if n_model > 1:
        for rx, dim in _TP_RULES:
            if rx.search(name):
                return dim if shape[dim] % n_model == 0 else None
    return None


def shard_tensor(t: torch.Tensor, dim: int, n_model: int,
                 index: int) -> torch.Tensor:
    """Rank ``index``'s contiguous slice of ``t`` along ``dim``."""
    return t.chunk(n_model, dim=dim)[index].contiguous()


def shard_state(state, mesh: Mesh) -> int:
    """Cut a full ``TrainState`` to this rank's shards in place: each
    parameter the TP rules split, its two optimizer moments with it; the
    WN stacks that hold them run tensor-parallel from then on. Returns the
    number of parameters split."""
    from radmmm_torch.ops.coupling import WN
    if mesh.n_model == 1:
        return 0
    opt = state.optimizer
    index = {id(p): i for i, p in enumerate(opt.params)}
    opt.shard_group = mesh.model
    for name, p in state.model.named_parameters():
        dim = param_spec(name, p.shape, mesh.n_model)
        if dim is None:
            continue
        mesh.layout[name] = (dim, tuple(p.shape))
        cut = lambda t: shard_tensor(t, dim, mesh.n_model, mesh.model_index)
        with torch.no_grad():
            p.data = cut(p.data)
            i = index[id(p)]
            opt.exp_avg[i] = cut(opt.exp_avg[i])
            opt.exp_avg_sq[i] = cut(opt.exp_avg_sq[i])
        opt.sharded[i] = True
    for name, m in state.model.named_modules():
        if isinstance(m, WN) and f"{name}.start.v" in mesh.layout:
            m.tp = mesh.model
    return len(mesh.layout)


def assert_tp_layout(model: torch.nn.Module, mesh: Mesh,
                     min_sharded: int = 1) -> int:
    """Fail loudly unless every parameter the TP rules match holds this
    rank's shard, not the full tensor, and at least ``min_sharded`` do.
    Returns the number that do."""
    if mesh.n_model <= 1:
        return 0
    bad, n_ok = [], 0
    for name, p in model.named_parameters():
        full = mesh.layout.get(name, (None, tuple(p.shape)))[1]
        dim = param_spec(name, full, mesh.n_model)
        if dim is None:
            continue
        want = full[:dim] + (full[dim] // mesh.n_model,) + full[dim + 1:]
        if tuple(p.shape) != want:
            bad.append((name, tuple(p.shape), want))
        else:
            n_ok += 1
    if bad:
        lines = "\n".join(f"  {n}: shape {a}, a shard is {e}"
                          for n, a, e in bad[:12])
        raise AssertionError(
            f"{len(bad)} parameter(s) matching the TP rules are NOT split "
            f"over the '{MODEL_AXIS}' group:\n{lines}")
    if n_ok < min_sharded:
        raise AssertionError(
            f"only {n_ok} parameter(s) split over '{MODEL_AXIS}' (expected "
            f">= {min_sharded}): silent replication?")
    return n_ok


def collective_stats() -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes"}} of the collectives the card ran since
    ``reset_collective_stats`` (a graph's at each replay)."""
    out: Dict[str, Dict[str, int]] = {}
    for (kind, field), n in C.STATS.items():
        out.setdefault(kind, {"count": 0, "bytes": 0})[field] = n
    return out


def reset_collective_stats() -> None:
    C.reset_stats()
