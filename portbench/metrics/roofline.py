"""A kernel family's share of its roofline: the sum of its launches'
least times (``ctx["bound_ms"][family]``) over the sum of the device time
of the trace's kernels named in ``kernels/<family>.json``."""
from portbench import harness


def share(family, ctx):
    names = harness.kernel_spec(family)["names"]
    t = harness.kernel_time_s(ctx["summary"], names)
    bound = ctx.get("bound_ms", {}).get(family)
    if t <= 0 or not bound:
        return None
    return 100.0 * bound / 1e3 / t
