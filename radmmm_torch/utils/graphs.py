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
    out = step({"x": x})          # first call at a signature: eager
    out = step({"x": x2})         # second: captured, then replayed
    out = step({"x": x3})         # later calls replay

On CPU inputs ``Graphed`` calls ``fn`` and nothing else, so the tests run
the same code eagerly. On the card:

- The first call at a signature is the warm-up PyTorch asks for before a
  capture: ``fn`` runs eagerly on the pool's side stream and its result is
  that call's result. A signature seen once (a corpus's one-off tail
  shape) costs no capture. The second call captures on the same stream
  and replays at once: the capture launches nothing, so it leaves the
  card's tensors as they were and the replay computes this call.
  Host-side state that ``fn`` changes during the capture (Python
  attributes, the counters below) is the caller's to keep out of ``fn``
  or, for the counters, the ledger's to put back.
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
- The ledger: the host-side counters that tick where a call queues work
  on the card (``utils/launches.TALLIES``: the kernel wrappers' launches,
  the collectives' counts and bytes) tick while a graph is captured and
  never while it replays. What goes into the graph ticks the capture's
  record instead of the counters (``launches.begin_capture`` to
  ``end_capture``: the capturing thread's calls and the autograd
  engine's on the capture's stream; another thread's replays and
  launches meanwhile count as ever); each replay adds the record, so the
  counters stay the work the card ran.
- Collectives inside ``fn`` (NCCL's) are captured with it: the warm-up's
  eager collectives create the communicators first, and every rank
  captures at the same call, since each sees the same signatures in the
  same order. gloo's cannot be captured (its CUDA tensors go through host
  memory); its callers keep their steps eager.
- Several threads (the trainer's and its loaders', each with its own
  pool: ``data/collate.Featurizer``) may warm up, capture and replay.
  One process-wide lock is held by every warm-up and every capture and by
  no replay, so no two threads warm up or capture at once: a warm-up and
  a capture synchronise and empty the allocator's cache device-wide,
  which CUDA refuses while another thread captures, and a replay
  on another thread is legal under a capture (``thread_local`` mode) and
  need not wait. Other code that synchronises the whole device, or starts
  or stops a profiler, while a loader may capture takes the lock too
  (``synchronize``, ``no_capture``). A pool's graphs are still never run
  at once by two threads: its owner serialises its calls.
- The cyclic garbage collector is off during a capture (under the lock,
  so two captures never turn it on and off across each other): a
  collection there could destroy an unreachable graph of an object that
  held one in a reference cycle, and a capture refuses that (its stream
  is invalidated).
- A failed capture or replay raises: there is no quiet way back to the
  eager path.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree

from radmmm_torch.ops.conv import get_conv_precision
from radmmm_torch.utils import launches


# held by every warm-up and capture of the process, by no replay
_CAPTURING = threading.RLock()


def no_capture():
    """A context in which no other thread warms up or captures, for what
    must not meet another thread's capture: CUDA refuses a
    device-wide synchronisation while any stream captures."""
    return _CAPTURING


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)`` once no other thread captures."""
    with _CAPTURING:
        torch.cuda.synchronize(device)


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
    record of their warm-ups, captures and replays. The pool and the
    stream are made at the first warm-up, so a GraphPool costs nothing on
    the CPU."""

    def __init__(self):
        self.handle = self.stream = None
        self.captures: List[Capture] = []
        self.warmups = self.replays = 0

    def open(self) -> torch.cuda.Stream:
        """The pool's side stream, made with the pool on first use."""
        if self.stream is None:
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream()
        return self.stream


# a ``pool=`` argument's default where its owner takes a pool of its own
OWN_POOL = "own"


def own_pool(pool: Union[GraphPool, str, None]) -> Optional[GraphPool]:
    """``pool``, ``OWN_POOL`` made a new ``GraphPool`` (None: eager)."""
    return GraphPool() if pool == OWN_POOL else pool


def graph_program(fn: Callable, pool: Union[GraphPool, str, None],
                  name: str = "") -> Callable:
    """``fn`` as ``program(inputs, key=())``: through ``Graphed`` in
    ``pool`` (``OWN_POOL``: a new pool), or ``fn`` itself where ``pool``
    is None."""
    pool = own_pool(pool)
    if pool is None:
        return lambda inputs, key=(): fn(inputs)
    return Graphed(fn, pool, name=name)


def _signature(tree) -> tuple:
    leaves, spec = pytree.tree_flatten(tree)
    return (str(spec),) + tuple(
        (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
        else t for t in leaves)


class StepGraph:
    """``fn`` at one input signature on the card: eager at the first call,
    captured and replayed at the second, replayed after (see the module
    docstring)."""

    def __init__(self, fn: Callable, pool: GraphPool,
                 generators: Sequence[torch.Generator] = (), name: str = "",
                 signature: tuple = ()):
        self.fn, self.pool, self.name = fn, pool, name
        self.signature = signature
        self.generators = list(generators)
        self.warmed = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in = self.static_out = None
        # what the capture took from the ledger's counters
        self.added: List[collections.Counter] = []

    def __call__(self, inputs):
        if self.graph is None:
            if not self.warmed:
                return self._warm_up(inputs)
            self._capture(inputs)
        else:
            for s, x in zip(pytree.tree_leaves(self.static_in),
                            pytree.tree_leaves(inputs)):
                if isinstance(s, torch.Tensor):
                    s.copy_(x)
        self.graph.replay()
        self.pool.replays += 1
        launches.add_record(self.added)
        return _clone(self.static_out)

    def _warm_up(self, inputs):
        side = self.pool.open()
        with _CAPTURING:
            # the warm-up allocates on the side stream, which cannot take
            # the blocks the allocator keeps for the other streams: those
            # go back first, so the card never holds two steps' worth of
            # cached blocks
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self.fn(inputs)
            torch.cuda.synchronize()
        self.warmed = True
        self.pool.warmups += 1
        return out

    def _capture(self, inputs):
        self.static_in = _clone(inputs)
        side = self.pool.open()
        with _CAPTURING:
            torch.cuda.synchronize()
            # what the allocator caches outside the graphs goes back, so
            # the reserved bytes grow by the pool's share alone
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            for g in self.generators:
                graph.register_generator_state(g)
            # other threads (the loaders' uploads and replays, NCCL's
            # watchdog) keep running: only this thread's calls must be
            # legal under capture
            collecting = gc.isenabled()
            gc.disable()
            launches.begin_capture()
            try:
                with torch.cuda.graph(graph, pool=self.pool.handle,
                                      stream=side,
                                      capture_error_mode="thread_local"):
                    self.static_out = self.fn(self.static_in)
            finally:
                self.added = launches.end_capture()
                if collecting:
                    gc.enable()
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            grown = torch.cuda.memory_reserved() - reserved
        self.graph = graph
        self.pool.captures.append(Capture(
            self.name, self.signature, seconds, grown, dict(self.added[0])))


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
