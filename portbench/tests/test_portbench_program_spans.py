"""The readers of the port's own spans, counters and device marks, on a
hand-made trace summary that holds mark kernels and on hand-made program
records: each reads its number, and returns nothing where there is
nothing to read (a program without marks or records)."""
import math

import pytest

from portbench import harness
from radmmm_torch.utils import profiling
from radmmm_torch.utils.profiling import Record


def _mark(phase, end, a):
    return (f"radmmm_mark_{phase}_{end}", a, a + 1)


def _summary():
    """Two steps' featurize phases and two requests' stages, in us."""
    dev = [_mark("train_featurize", "begin", 0), ("mel", 1, 5),
           ("pyin", 3, 8), ("reduce", 10, 12),
           _mark("train_featurize", "end", 12), ("gemm", 13, 19),
           _mark("train_featurize", "begin", 20), ("pyin", 21, 31),
           _mark("train_featurize", "end", 31)]
    dev += [_mark("serve_stage_a", "begin", 100), ("lstm", 101, 104),
            _mark("serve_stage_a", "end", 104), ("memcpy", 106, 107),
            _mark("serve_stage_b", "begin", 108), ("conv", 110, 129),
            _mark("serve_stage_b", "end", 129),
            _mark("serve_stage_a", "begin", 140), ("lstm", 141, 144),
            _mark("serve_stage_a", "end", 144),
            _mark("serve_stage_b", "begin", 150), ("conv", 151, 169),
            _mark("serve_stage_b", "end", 169)]
    return {"device": dev, "busy_s": 1e-4, "window_s": 2e-4,
            "host_calls": {}, "spans": []}


def _records():
    def rec(name, a, b, value=None):
        return Record(name, a, b, 1, 0, None, 1, value)
    return [rec("dispatch.queue", 0, 1_000_000),
            rec("dispatch.queue", 0, 3_000_000),
            rec("dispatch.queue", 0, 2_000_000),
            rec("serve.frames_needed", 5, 5, 150),
            rec("serve.frames_bucket", 5, 5, 192),
            rec("serve.frames_needed", 9, 9, 300),
            rec("serve.frames_bucket", 9, 9, 384),
            rec("serving.stage_a", 1, 2)]


@pytest.fixture
def program(monkeypatch):
    recs = _records()
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    return recs


@pytest.mark.parametrize("name,want", [
    ("featurize_ms.train", (7 + 2 + 10) / 2 / 1e3),
    ("stage_gap_ms.serve_single", (3 + 5) / 2 / 1e3),
    ("request_gap_ms.serve_single", 10 / 1e3),
    ("queue_wait_ms.serve_single", 2.0),
    ("bucket_pad_pct.serve_single", 100 * (576 - 450) / 576),
])
def test_a_reader_reads_the_programs_number(name, want, program):
    ctx = {"kind": "serve", "summary": _summary(), "units": 2}
    got = harness.metric_reader(name).read(name, ctx)
    assert math.isclose(got, want, rel_tol=1e-9), (name, got, want)


@pytest.mark.parametrize("name", [
    "featurize_ms.train", "stage_gap_ms.serve_single",
    "request_gap_ms.serve_single", "queue_wait_ms.serve_single",
    "bucket_pad_pct.serve_single"])
@pytest.mark.parametrize("program_has", ["nothing recorded", "no records"])
def test_a_reader_with_nothing_to_read_returns_nothing(name, program_has,
                                                       monkeypatch):
    if program_has == "no records":
        monkeypatch.delattr(profiling, "records")
    else:
        monkeypatch.setattr(profiling, "records", lambda: [])
    summary = _summary()
    summary["device"] = [d for d in summary["device"]
                         if not d[0].startswith("radmmm_mark_")]
    ctx = {"kind": "serve", "summary": summary, "units": 2}
    assert harness.metric_reader(name).read(name, ctx) is None
