"""queue_wait_ms.<kind>: the median over the traced window's requests of
the port's ``dispatch.queue`` span (a request's wait from the caller's
``put`` to the start of its call on ``DeviceDispatcher``'s thread)."""
import statistics

from portbench import harness

_program = harness.load_module(harness.ROOT / "metrics" / "program.py",
                               "portbench_metric_program")


def read(name, ctx):
    waits = _program.records("dispatch.queue")
    if not waits:
        return None
    return statistics.median(r.end_ns - r.start_ns for r in waits) / 1e6
