"""The per-layer readers on a hand-made trace summary: each reads what
it should, and one that finds nothing to read returns nothing."""
import math

import pytest

from portbench import harness
from portbench.bounds import PEAK_F32_FLOP_PER_S


def _ctx():
    summary = {
        "window_s": 1e-3 * 0.2, "busy_s": 1e-6 * 150,
        "device": [("lstm_recurrence_kernel<true>", 0, 40),
                   ("lstm_recurrence_bwd_kernel", 40, 80),
                   ("ctc_alpha_kernel", 100, 110), ("gemm", 120, 150)],
        "host_calls": {"cudaGraphLaunch": 2, "cudaMemcpyAsync": 8},
        "spans": [("portbench.request", 0, 100),
                  ("portbench.request", 100, 200)]}
    return {"kind": "train", "summary": summary, "units": 2,
            "flops": 1e6, "bound_ms": {"lstm": 0.04, "dp": 0.005},
            "replays": 2, "frame_pad": [10.0, 30.0]}


@pytest.mark.parametrize("name,want", [
    ("device_idle_pct.train", 100 * (1 - 150 / 200)),
    ("mfu.train", 100 * 1e6 / 2e-4 / PEAK_F32_FLOP_PER_S),
    ("step_busy_ms.train", 0.075),
    ("graph_replay_pct.train", 100.0),
    ("host_launch_calls.train", 5.0),
    ("lstm_roofline_pct.train", 100 * 0.04e-3 / 80e-6),
    ("dp_roofline_pct.train", 100 * 0.005e-3 / 10e-6),
    ("frame_pad_pct.serve_single", 20.0),
    ("request_host_ms.serve_single", (100 - 80 + 100 - 40) / 2 / 1e3),
])
def test_a_reader_reads_its_number(name, want):
    got = harness.metric_reader(name).read(name, _ctx())
    assert math.isclose(got, want, rel_tol=1e-9), (name, got, want)


@pytest.mark.parametrize("name", ["lstm_roofline_pct.train",
                                  "frame_pad_pct.serve_batch",
                                  "request_host_ms.serve_single"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    ctx = _ctx()
    ctx["summary"]["device"] = [("gemm", 0, 10)]
    ctx["summary"]["spans"] = []
    ctx["frame_pad"] = []
    assert harness.metric_reader(name).read(name, ctx) is None
