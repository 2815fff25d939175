"""CUDA graphs of the port's fixed-shape programs.

The JAX package compiles one program per static shape (``jax.jit``) and
dispatches it once per call. The counterpart here is a captured CUDA
graph: the kernels of one call at one input signature, recorded once and
launched again by a single ``cudaGraphLaunch``. ``Graphed(fn)`` keeps one
``StepGraph`` per signature of its inputs (the shapes and dtypes of a dict
of tensors, plus a key the caller adds for what the shapes do not say,
such as a training phase):

    step = Graphed(lambda x: {"y": model(x["x"])}, generators=[gen],
                   name="step")
    out = step({"x": x})          # first call at a signature: eager, then
    out = step({"x": x2})         # captured; later calls replay

On CPU inputs ``Graphed`` calls ``fn`` and nothing else, so the tests run
the same code eagerly. On the card:

- The first call at a signature is the warm-up PyTorch asks for before a
  capture: ``fn`` runs eagerly on the pool's side stream and its result is
  that call's result. The capture follows on the same stream; it launches
  nothing, so it leaves the card's tensors as they were. Host-side state
  that ``fn`` changes during the capture (Python attributes, the kernel
  wrappers' launch counts) is the caller's to keep out of ``fn`` or, for
  the counts, the ledger's to put back.
- Inputs are copied into static buffers before each replay, and outputs
  are cloned out after it, so a caller may hold them across replays.
- Every graph of a ``GraphPool`` allocates from one private memory pool
  and is warmed up and captured on the pool's one side stream. Its graphs
  never run at once and each replay reads only its static inputs and
  tensors that live outside the pool (parameters, optimizer moments,
  buffers), so they share the memory of each other's intermediates: the
  caching allocator reuses a free block only on the stream that allocated
  it, so a capture on the pool's stream takes the blocks the earlier
  captures freed, and the pool grows to the largest of the graphs'
  intermediates plus each graph's static outputs.
- ``generators`` are registered with each graph
  (``CUDAGraph.register_generator_state``): a replay draws the bits the
  same calls would draw eagerly from the generator's current offset, and
  advances it as they would.
- The launch ledger: the kernel wrappers count their launches in one
  registry (``utils/launches.py``), which ticks while a graph is captured
  and never while it replays. A capture takes back what it added and
  records it; each replay adds it again, so the counts stay the number of
  kernels the card ran.
- A failed capture or replay raises: there is no quiet way back to the
  eager path.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from radmmm_torch.ops.conv import get_conv_precision
from radmmm_torch.utils.launches import launch_counts


@dataclasses.dataclass
class Capture:
    """One capture: its graph's name and signature (the caller's key, the
    conv precision, the inputs' tree and shapes), the seconds the
    capture took (the eager warm-up not included), the bytes the card's
    reserved memory grew by (the shared pool's growth) and the kernel
    launches the ledger adds on each replay."""
    name: str
    signature: tuple
    seconds: float
    pool_bytes: int
    launches: Dict[str, int]


class GraphPool:
    """One private memory pool and one side stream for a set of graphs
    that never run at once (a trainer's steps, a server's stages), and the
    record of their captures. The pool and the stream are made at the
    first capture, so a GraphPool costs nothing on the CPU."""

    def __init__(self):
        self.handle = self.stream = None
        self.captures: List[Capture] = []
        self.replays = 0

    def open(self) -> torch.cuda.Stream:
        """The pool's side stream, made with the pool on first use."""
        if self.stream is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        return self.stream


def _signature(tree) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
        else t for t in leaves)


class StepGraph:
    """``fn`` at one input signature on the card: eager and captured at the
    first call, replayed at the next (see the module docstring)."""

    def __init__(self, fn: Callable, pool: GraphPool,
                 generators: Sequence[torch.Generator] = (), name: str = "",
                 signature: tuple = ()):
        self.fn, self.pool, self.name = fn, pool, name
        self.signature = signature
        self.generators = list(generators)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in = self.static_out = None
        self.launches: Dict[str, int] = {}

    def __call__(self, inputs):
        if self.graph is None:
            return self._warm_and_capture(inputs)
        for s, x in zip(pytree.tree_leaves(self.static_in),
                        pytree.tree_leaves(inputs)):
            if isinstance(s, torch.Tensor):
                s.copy_(x)
        self.graph.replay()
        self.pool.replays += 1
        launch_counts.update(self.launches)
        return _clone(self.static_out)

    def _warm_and_capture(self, inputs):
        self.static_in = _clone(inputs)
        side = self.pool.open()
        # the warm-up allocates on the side stream, which cannot take the
        # blocks the allocator keeps for the other streams: those go back
        # first, so the card never holds two steps' worth of cached blocks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.fn(self.static_in)
        torch.cuda.synchronize()
        # what the allocator caches outside the graphs goes back, so the
        # reserved bytes grow by the pool's share alone
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = collections.Counter(launch_counts)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        # other threads (the loader's uploads) keep running: only this
        # thread's calls must be legal under capture
        with torch.cuda.graph(graph, pool=self.pool.handle, stream=side,
                              capture_error_mode="thread_local"):
            self.static_out = self.fn(self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        self.launches = dict(launch_counts - before)
        launch_counts.clear()
        launch_counts.update(before)
        self.graph = graph
        self.pool.captures.append(Capture(
            self.name, self.signature, seconds,
            torch.cuda.memory_reserved() - reserved, dict(self.launches)))
        return out


def _clone(tree):
    return pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class Graphed:
    """``fn`` over a pytree of tensors: on the card one ``StepGraph`` per
    input signature, ``key`` and conv precision; on the CPU ``fn``
    itself."""

    def __init__(self, fn: Callable, pool: Optional[GraphPool] = None,
                 generators: Sequence[torch.Generator] = (), name: str = ""):
        self.fn, self.name = fn, name
        self.pool = pool if pool is not None else GraphPool()
        self.generators = list(generators)
        self.graphs: Dict[tuple, StepGraph] = {}

    def __call__(self, inputs, key: tuple = ()):
        leaves = [t for t in pytree.tree_leaves(inputs)
                  if isinstance(t, torch.Tensor)]
        if not leaves or leaves[0].device.type != "cuda":
            return self.fn(inputs)
        # the conv precision is process-wide and changes the kernels
        sig = (key, get_conv_precision()) + _signature(inputs)
        g = self.graphs.get(sig)
        if g is None:
            g = self.graphs[sig] = StepGraph(self.fn, self.pool,
                                             self.generators, self.name, sig)
        return g(inputs)
