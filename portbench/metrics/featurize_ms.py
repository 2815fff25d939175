"""featurize_ms.<kind>: the mean over the traced window's steps of the
device's busy ms between the ``train.featurize`` marks (mel, pYIN, energy
and prior inside the step's graph)."""
from portbench import harness

_marks = harness.load_module(harness.ROOT / "metrics" / "marks.py",
                             "portbench_metric_marks")


def read(name, ctx):
    s = ctx["summary"]
    runs = _marks.phase(s, "train.featurize")
    if not runs:
        return None
    busy = _marks.busy_us(s, runs)
    return sum(busy) / len(busy) / 1e3
