"""request_gap_ms.<kind>: the median over the traced window's consecutive
requests of the device time from one request's ``serve.stage_b`` end mark
to the next one's ``serve.stage_a`` begin mark (the fetch and trim, the
return, the next request's encoding, padding, queue and stage A's input
copies)."""
from portbench import harness

_marks = harness.load_module(harness.ROOT / "metrics" / "marks.py",
                             "portbench_metric_marks")


def read(name, ctx):
    return _marks.median_gap_ms(ctx["summary"],
                                "radmmm_mark_serve_stage_b_end",
                                "radmmm_mark_serve_stage_a_begin")
