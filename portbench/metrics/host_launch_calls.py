"""host_launch_calls.<kind>: the host's runtime calls that queue work on
the card (kernel and graph launches, copies, fills), from the profiler's
host events, a step of the traced window."""


def read(name, ctx):
    if not ctx["units"]:
        return None
    return sum(ctx["summary"]["host_calls"].values()) / ctx["units"]
