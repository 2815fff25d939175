"""dp_roofline_pct.<kind>: K1, K2 and K3's share of their roofline over
the traced window."""
from portbench import harness

_roof = harness.load_module(harness.ROOT / "metrics" / "roofline.py",
                            "portbench_metric_roofline")


def read(name, ctx):
    return _roof.share("dp", ctx)
