"""align_ms.<kind>: the device's busy ms between the ``train.align``
marks, summed over a step's runs and averaged over the traced window's
steps: the training forward's alignment work (the attention's
projections, distance and prior, MAS, and the CTC loss's forward), not
its backward. A trace without the marks reads as no value."""
from portbench import harness

_marks = harness.load_module(harness.ROOT / "metrics" / "marks.py",
                             "portbench_metric_marks")


def read(name, ctx):
    runs = _marks.phase(ctx["summary"], "train.align")
    if not runs or not ctx["units"]:
        return None
    return sum(_marks.busy_us(ctx["summary"], runs)) / ctx["units"] / 1e3
