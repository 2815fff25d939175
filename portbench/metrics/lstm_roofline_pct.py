"""lstm_roofline_pct.<kind>: K4's (and in training K4-bwd's) share of
its roofline over the traced window."""
from portbench import harness

_roof = harness.load_module(harness.ROOT / "metrics" / "roofline.py",
                            "portbench_metric_roofline")


def read(name, ctx):
    return _roof.share("lstm", ctx)
