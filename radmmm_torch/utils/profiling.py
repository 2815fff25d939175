"""What the port records about where its time goes: host spans, device
marks and counters, and a torch.profiler window over a run of training
steps.

Spans and counters record only while a torch profiler runs in the
process (the flag torch sets when any profiler starts,
``torch.autograd.profiler._is_profiler_enabled``); otherwise a span costs
one read of that flag and a shared no-op context. To get them, run any
torch.profiler window: the Trainer's (``profile_dir``: a Chrome trace
``trace.json`` there, with every thread's spans where the installed torch
allows it), or an operator's own ``torch.profiler.profile()`` around a
server's requests. Then read the Chrome trace, where each span is a
``record_function`` range on the device trace's clock, or ``records()``
in the same process.

- ``span(name)``: a host span. Its record holds the name, the start and
  end (``time.perf_counter_ns``), the thread, its own id, the span that
  caused it (the one open on the thread, or handed over with the work)
  and a request id that every span of one request shares. The records
  stay in memory, the newest ``MAX_RECORDS`` of them (``records()``,
  ``clear()``).
- ``count(name, n)``: a counter, recorded as a ``Record`` whose ``value``
  is ``n``.
- ``handoff()`` and ``handed(name, token)``: work that crosses threads;
  the thread that takes it records the wait as span ``name``, and its
  spans join the sender's request.
- ``device_span(name, device)``: a pair of empty kernels around a phase
  of device work, ``radmmm_mark_<name>_begin`` and ``..._end`` in the
  device trace, the name's dots as underscores (``csrc/marks.cu``).
  Inside a captured function they are captured with it, so every replay
  of the graph puts them on the device's timeline, whether a profiler
  runs or not: the only way to mark a phase inside a CUDA graph. They
  tick no launch counter; on the CPU they do nothing.
- ``train_span(name, device)``: ``device_span`` where autograd records,
  so in a training step's forward alone: validation and inference run
  under ``no_grad`` and carry none of these marks. They cover the
  forward's work, never its backward's.

The port's spans, counters and marks:

| Name | Kind | Where |
|---|---|---|
| ``service.request`` | span, a new request | ``server.TTSService.synthesize`` |
| ``service.fetch`` | span | there: the ``.cpu()`` copies and the trim |
| ``dispatch.queue`` | span, in ``records()`` only | ``server.DeviceDispatcher``: the caller's ``put`` to the start of the call on the dispatcher thread |
| ``serving.pad`` | span | ``serving.load_tts``'s call: the bucket pick and the padding |
| ``serving.stage_a`` | span | stage A's call |
| ``serving.bucket_pick`` | span | the ``n_frames`` fetch and the frame bucket's pick |
| ``serving.stage_b`` | span | stage B's call |
| ``serve.frames_needed`` | counter | the real rows' longest ``n_frames`` |
| ``serve.frames_bucket`` | counter | the frame bucket picked |
| ``train.loader_wait`` | span | ``Trainer._timed``: waiting on the loader |
| ``train.inputs`` | span | ``Trainer._run_step``: the batch's broadcast and ``step_inputs`` |
| ``train.step`` | span | ``Trainer._run_step``: the step's call |
| ``train.featurize`` | device marks | ``training/step.make_train_step``: ``featurize_raw`` inside the step |
| ``serve.stage_a`` | device marks | ``serving.make_two_stage_fns``: the body of stage A's graph |
| ``serve.stage_b`` | device marks | the same: the body of stage B's graph |
| ``train.align`` | device marks, ``train_span`` | ``models/tts.TTSModel.forward``: the attention (projections, distance, prior, MAS); ``losses/flow.attention_loss``: the CTC loss's forward. Two runs a step |
| ``train.attributes`` | device marks, ``train_span`` | ``models/tts.TTSModel.forward``: the four attribute predictors' forward |
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.graphs import no_capture

# the records kept: the newest, older ones dropped
MAX_RECORDS = 65536
# the device marks' names, in the order of csrc/marks.cu's RADMMM_MARKS
MARKS = ("train.featurize", "serve.stage_a", "serve.stage_b", "train.align",
         "train.attributes")


class Record(NamedTuple):
    """A span (``value`` None) or a counter (``start_ns == end_ns``)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    value: Optional[int] = None


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_requests = itertools.count(1)
# each thread's (open span's id, request id)
_local = threading.local()


def _current() -> tuple:
    return getattr(_local, "current", (None, None))


# the shared context of what records nothing
_NOOP = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "new_request", "on", "start_ns", "end_ns", "_id",
                 "_prev", "_request", "_range")

    def __init__(self, name: str, new_request: bool = False,
                 on: bool = True):
        self.name, self.new_request, self.on = name, new_request, on

    def __enter__(self):
        if self.on:
            self._prev = _current()
            self._request = (next(_requests) if self.new_request
                             else self._prev[1])
            self._id = next(_ids)
            _local.current = (self._id, self._request)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        if self.on:
            self._range.__exit__(*exc)
            _local.current = self._prev
            _records.append(Record(
                self.name, self.start_ns, self.end_ns, threading.get_ident(),
                self._id, self._prev[0], self._request))
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, new_request: bool = False):
    """Host span ``name`` around a ``with`` block, under the thread's open
    span; ``new_request`` starts a request of its own. Records nothing
    unless a profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, new_request)


def timed(name: str) -> _Span:
    """``span(name)`` that reads the clock whether or not it records:
    ``.seconds`` after the block."""
    return _Span(name, on=_autograd_profiler._is_profiler_enabled)


def count(name: str, n: int) -> None:
    """Counter ``name`` by ``n``, under the thread's open span, while a
    profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        t = time.perf_counter_ns()
        parent, request = _current()
        _records.append(Record(name, t, t, threading.get_ident(), next(_ids),
                               parent, request, int(n)))


def handoff() -> Optional[tuple]:
    """What work handed to another thread carries: None unless a profiler
    runs, else the sender's (open span, request, time)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    return _current() + (time.perf_counter_ns(),)


class _Handed:
    __slots__ = ("token", "_prev")

    def __init__(self, token: tuple):
        self.token = token

    def __enter__(self):
        self._prev = _current()
        _local.current = self.token[:2]
        return self

    def __exit__(self, *exc):
        _local.current = self._prev
        return False


def handed(name: str, token: Optional[tuple]):
    """On the thread that takes the work: records span ``name`` from the
    ``handoff()`` that made ``token`` to now, and runs the block under the
    sender's span and request. Nothing where ``token`` is None."""
    if token is None:
        return _NOOP
    parent, request, t0 = token
    _records.append(Record(name, t0, time.perf_counter_ns(),
                           threading.get_ident(), next(_ids), parent,
                           request))
    return _Handed(token)


def records() -> List[Record]:
    """The records kept, oldest first."""
    return list(_records)


def clear() -> None:
    _records.clear()


def _declare_marks(lib: ctypes.CDLL) -> None:
    lib.radmmm_mark_launch.argtypes = [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.radmmm_mark_launch.restype = ctypes.c_int
    lib.radmmm_mark_count.restype = ctypes.c_int
    lib.radmmm_mark_name.argtypes = [ctypes.c_int]
    lib.radmmm_mark_name.restype = ctypes.c_char_p
    built = [lib.radmmm_mark_name(i).decode()
             for i in range(lib.radmmm_mark_count())]
    if built != [m.replace(".", "_") for m in MARKS]:
        raise RuntimeError(f"csrc/marks.cu marks {built}, profiling.MARKS "
                           f"{MARKS}")


def _mark(index: int, end: int, device: torch.device) -> None:
    lib = cuda_build.load("marks", _declare_marks)
    with torch.cuda.device(device):
        err = lib.radmmm_mark_launch(index, end,
                                     torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "device mark")


class _Marks:
    __slots__ = ("index", "device")

    def __init__(self, index: int, device: torch.device):
        self.index, self.device = index, device

    def __enter__(self):
        _mark(self.index, 0, self.device)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _mark(self.index, 1, self.device)
        return False


def device_span(name: str, device):
    """The device marks of phase ``name`` (one of ``MARKS``) around the
    work a ``with`` block queues on ``device``'s current stream; nothing
    off the card."""
    index = MARKS.index(name)
    device = torch.device(device)
    if device.type != "cuda":
        return _NOOP
    return _Marks(index, device)


def train_span(name: str, device):
    """``device_span(name, device)`` inside a training step (autograd
    recording), nothing under ``no_grad``."""
    if not torch.is_grad_enabled():
        return _NOOP
    return device_span(name, device)


def union_length(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def _all_threads():
    """The profiler's setting that records every thread's ranges (the
    loaders', the dispatcher's), where the installed torch has it."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


class StepProfiler:
    """Profiles steps ``start_step`` to ``start_step + n_steps - 1`` (the
    step numbers the caller passes, counted from 0) into a Chrome trace
    ``trace.json`` under ``directory``, every thread's spans in it where
    the installed torch allows, and records the window's wall time, the
    device's busy time (the union of its kernels', copies' and sets'
    intervals), their summed time and the kernels that took most of it.
    Off when ``directory`` is None."""

    def __init__(self, directory: Optional[str], start_step: int,
                 n_steps: int, device: torch.device, top: int = 12):
        self.directory, self.start_step = directory, start_step
        self.n_steps, self.device, self.top = n_steps, device, top
        self._prof = None
        self._t0 = 0.0
        self.stats: dict = {}

    def before(self, step: int) -> None:
        if self.directory and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts,
                                 experimental_config=_all_threads())
            # a loader's thread may be capturing its featurize graph
            with no_capture():
                self._prof.start()
            self._t0 = time.perf_counter()

    def after(self, step: int) -> None:
        if (self._prof is not None
                and step + 1 == self.start_step + self.n_steps):
            self._finish()

    def stop(self) -> None:
        """Stop a window the run left open, recording nothing."""
        if self._prof is not None:
            with no_capture():
                self._prof.stop()
            self._prof = None

    def _finish(self) -> None:
        from torch.autograd import DeviceType
        with no_capture():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - self._t0
            prof, self._prof = self._prof, None
            prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "trace.json")
        prof.export_chrome_trace(path)
        # the device's own activity: kernels, copies and sets, without the
        # user annotations (an optimizer's step range) that span them
        def on_device(e):
            return (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))

        kernels = sorted(((e.key, e.device_time_total / 1e3)
                          for e in prof.key_averages() if on_device(e)),
                         key=lambda kv: -kv[1])
        # busy: the union of the activity's intervals, since kernels can
        # overlap on the card
        busy = union_length((e.time_range.start, e.time_range.end)
                            for e in prof.events() if on_device(e)) / 1e6
        self.stats = dict(profile_wall_s=wall, profile_busy_s=busy,
                          profile_kernel_s=sum(ms for _, ms in kernels) / 1e3,
                          profile_steps=self.n_steps,
                          profile_top_ms=kernels[:self.top])
        print(f"profiler trace in {path}: {self.n_steps} steps, "
              f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
              f"(kernel time summed {self.stats['profile_kernel_s'] * 1e3:.1f}"
              " ms)")
