"""graph_replay_pct.<kind>: the steps of the traced window that replayed
a CUDA graph (the step pool's ``GraphPool.replays`` read before and after
the window), as a share of its steps."""


def read(name, ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return 100.0 * ctx["replays"] / ctx["units"]
