"""radmmm_torch.utils.profiling: the union of overlapping device intervals
(the busy time of a profiled window), a window's bookkeeping on the CPU,
where no device activity is recorded, and the host spans, counters and
device marks: off without a profiler, parents and requests under one,
across the dispatcher's thread, a bounded buffer, and marks that do
nothing on the CPU."""
import json
import os
import re
import sys
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from radmmm_torch.server import DeviceDispatcher
from radmmm_torch.utils import profiling
from radmmm_torch.utils.launches import launch_counts
from radmmm_torch.utils.profiling import StepProfiler, union_length
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("spans, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(5, 12), (0, 10)], 12.0),                  # overlapping, unsorted
    ([(0, 10), (2, 3), (20, 25), (24, 30)], 20.0),  # nested and chained
    ([(0, 1), (1, 2)], 2.0),                     # touching
])
def test_union_length(spans, want):
    assert union_length(spans) == want


def test_window_records_its_steps(tmp_path):
    prof = StepProfiler(str(tmp_path), 1, 2, torch.device("cpu"))
    x = torch.randn(64, 64)
    for step in range(4):
        prof.before(step)
        x = torch.tanh(x @ x)
        prof.after(step)
        assert bool(prof.stats) == (step >= 2)
    st = prof.stats
    assert st["profile_steps"] == 2 and st["profile_wall_s"] > 0
    assert st["profile_busy_s"] == st["profile_kernel_s"] == 0.0
    assert os.path.exists(tmp_path / "trace.json")


def test_window_traces_every_threads_spans(tmp_path):
    def loader():
        with profiling.span("train.loader_wait"):
            pass

    prof = StepProfiler(str(tmp_path), 0, 1, torch.device("cpu"))
    prof.before(0)
    with profiling.span("train.step"):
        t = threading.Thread(target=loader)
        t.start()
        t.join()
    prof.after(0)
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train.step", "train.loader_wait"} <= names


@pytest.mark.parametrize("record", [
    lambda: profiling.span("x").__enter__(),
    lambda: profiling.count("x", 3),
    lambda: profiling.handed("x", profiling.handoff()).__enter__(),
], ids=["span", "count", "handoff"])
def test_nothing_records_without_a_profiler(record):
    profiling.clear()
    record()
    assert profiling.records() == []
    assert profiling.span("x") is profiling.span("y")   # one shared no-op


def test_timed_reads_the_clock_without_a_profiler():
    profiling.clear()
    with profiling.timed("train.loader_wait") as t:
        pass
    assert t.seconds >= 0 and profiling.records() == []


def test_spans_carry_their_parent_and_request():
    profiling.clear()
    with _profiled():
        with profiling.span("outer", new_request=True) as outer:
            with profiling.span("inner"):
                profiling.count("n", 7)
        with profiling.span("next", new_request=True):
            pass
    recs = {r.name: r for r in profiling.records()}
    assert [r.name for r in profiling.records()] == ["n", "inner", "outer",
                                                     "next"]
    assert recs["outer"].parent is None and recs["outer"].id == outer._id
    assert recs["inner"].parent == outer._id
    assert recs["n"].parent == recs["inner"].id and recs["n"].value == 7
    assert recs["outer"].request == recs["inner"].request \
        == recs["n"].request != recs["next"].request
    assert recs["outer"].start_ns <= recs["inner"].start_ns \
        <= recs["inner"].end_ns <= recs["outer"].end_ns


def test_dispatcher_joins_the_callers_request():
    profiling.clear()

    def work(x):
        with profiling.span("work"):
            return x + 1

    dispatch = DeviceDispatcher(work)
    try:
        with _profiled():
            with profiling.span("caller", new_request=True) as caller:
                assert dispatch(1) == 2
        ident = dispatch._thread.ident
    finally:
        dispatch.close()
    recs = {r.name: r for r in profiling.records()}
    queue, done = recs["dispatch.queue"], recs["work"]
    assert queue.thread == done.thread == ident != threading.get_ident()
    assert queue.parent == done.parent == caller._id
    assert queue.request == done.request == recs["caller"].request
    assert queue.start_ns <= queue.end_ns <= done.start_ns


def test_threads_lose_no_record():
    """Spans of many threads at once, switching often: every span kept
    once, each under its own thread's request."""
    profiling.clear()
    n_threads, n_spans = 16, 100
    # every thread alive to the end, so no two share an ident
    alive = threading.Barrier(n_threads)

    def work():
        with profiling.span("request", new_request=True):
            for _ in range(n_spans):
                with profiling.span("inner"):
                    pass
        alive.wait(timeout=60)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiled():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = profiling.records()
    assert len(recs) == n_threads * (n_spans + 1)
    assert len({r.id for r in recs}) == len(recs)
    top = {r.thread: r for r in recs if r.name == "request"}
    assert len(top) == n_threads
    assert all(r.request == top[r.thread].request
               and r.parent == top[r.thread].id
               for r in recs if r.name == "inner")


def test_the_buffer_stays_bounded():
    profiling.clear()
    with _profiled():
        for i in range(profiling.MAX_RECORDS + 5):
            profiling.count("n", i)
    recs = profiling.records()
    assert len(recs) == profiling.MAX_RECORDS and recs[0].value == 5
    profiling.clear()
    assert profiling.records() == []


def test_device_marks_do_nothing_on_the_cpu():
    before = dict(launch_counts)
    with _profiled():
        mark = profiling.device_span("train.featurize", "cpu")
        with mark:
            x = torch.ones(3) * 2
    assert mark is profiling.span("x") and float(x.sum()) == 6
    assert dict(launch_counts) == before
    with pytest.raises(ValueError):
        profiling.device_span("no.such.mark", "cpu")


def test_marks_match_their_kernels_source():
    src = (Path(profiling.__file__).resolve().parents[1] / "csrc"
           / "marks.cu").read_text()
    listed = re.search(r"#define RADMMM_MARKS\(X\) (.*)", src).group(1)
    assert re.findall(r"X\((\w+)\)", listed) == [
        m.replace(".", "_") for m in profiling.MARKS]


def test_off_without_a_directory():
    prof = StepProfiler(None, 0, 1, torch.device("cpu"))
    prof.before(0)
    prof.after(0)
    prof.stop()
    assert prof.stats == {}
