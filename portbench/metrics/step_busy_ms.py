"""step_busy_ms.<kind>: the device's busy ms a step in the traced
window."""


def read(name, ctx):
    if ctx["kind"] != "train" or not ctx["units"]:
        return None
    return 1e3 * ctx["summary"]["busy_s"] / ctx["units"]
