"""stage_gap_ms.<kind>: the median over the traced window's requests of
the device time from the ``serve.stage_a`` end mark to the next
``serve.stage_b`` begin mark (the ``n_frames`` fetch, the host's bucket
pick, stage B's input copies and its graph's launch)."""
from portbench import harness

_marks = harness.load_module(harness.ROOT / "metrics" / "marks.py",
                             "portbench_metric_marks")


def read(name, ctx):
    return _marks.median_gap_ms(ctx["summary"],
                                "radmmm_mark_serve_stage_a_end",
                                "radmmm_mark_serve_stage_b_begin")
