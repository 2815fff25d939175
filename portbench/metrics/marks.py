"""The port's device marks in a trace summary: a phase's pair of empty
kernels, ``radmmm_mark_<phase>_begin`` and ``radmmm_mark_<phase>_end``
(``radmmm_torch/utils/profiling.device_span``), which a CUDA graph
replays around the phase. A summary without them (a program that has no
marks) reads as no pairs."""
import bisect
import statistics

from portbench import harness


def _marks(summary, kernel):
    return [(a, b) for n, a, b in summary["device"] if kernel in n]


def between(summary, first, second):
    """(end of a ``first`` mark, start of the ``second`` mark right after
    it), on the trace's clock (us), wherever no other ``first`` mark
    comes between the two."""
    seq = sorted([(b, 0) for _, b in _marks(summary, first)]
                 + [(a, 1) for a, _ in _marks(summary, second)])
    return [(t, u) for (t, k), (u, m) in zip(seq, seq[1:])
            if k == 0 and m == 1]


def median_gap_ms(summary, first, second):
    """The median of ``between``'s gaps in ms; None where there is none."""
    gaps = between(summary, first, second)
    if not gaps:
        return None
    return statistics.median(b - a for a, b in gaps) / 1e3


def phase(summary, name):
    """(end of the begin mark, start of the end mark) of each run of
    phase ``name`` (its dots as underscores)."""
    tag = "radmmm_mark_" + name.replace(".", "_")
    return between(summary, tag + "_begin", tag + "_end")


def busy_us(summary, spans):
    """The device's busy time (the union of its intervals) inside each of
    ``spans``."""
    dev = sorted((a, b) for _, a, b in summary["device"])
    if not dev:
        return [0.0 for _ in spans]
    starts = [a for a, _ in dev]
    longest = max(b - a for a, b in dev)
    out = []
    for a, b in spans:
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_right(starts, b)
        out.append(harness.union_length(
            (max(x, a), min(y, b)) for x, y in dev[lo:hi] if y > a and x < b))
    return out
