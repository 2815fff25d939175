"""attributes_ms.<kind>: the device's busy ms between the
``train.attributes`` marks, summed over a step's runs and averaged over
the traced window's steps: the forward of the four attribute predictors
(the duration predictor and the ganged frame predictors' recurrence with
their convolutions), not their backward. A trace without the marks reads
as no value."""
from portbench import harness

_marks = harness.load_module(harness.ROOT / "metrics" / "marks.py",
                             "portbench_metric_marks")


def read(name, ctx):
    runs = _marks.phase(ctx["summary"], "train.attributes")
    if not runs or not ctx["units"]:
        return None
    return sum(_marks.busy_us(ctx["summary"], runs)) / ctx["units"] / 1e3
