"""request_host_ms.<kind>: the median over the traced window's requests
of the benchmark's span around ``synthesize`` minus the device's busy
time inside it (the host's share of a request)."""
import bisect
import statistics

from portbench import harness


def read(name, ctx):
    s = ctx["summary"]
    spans = [(a, b) for n, a, b in s["spans"] if n == "portbench.request"]
    if not spans or not s["device"]:
        return None
    dev = sorted((a, b) for _, a, b in s["device"])
    starts = [a for a, _ in dev]
    longest = max(b - a for a, b in dev)
    own = []
    for a, b in spans:
        lo = bisect.bisect_left(starts, a - longest)
        hi = bisect.bisect_right(starts, b)
        busy = harness.union_length(
            (max(x, a), min(y, b)) for x, y in dev[lo:hi] if y > a and x < b)
        own.append((b - a - busy) / 1e3)
    return statistics.median(own)
