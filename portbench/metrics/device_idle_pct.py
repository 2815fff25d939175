"""device_idle_pct.<kind>: the share of the traced window in which no
operation ran on the device (100 minus the union of its kernel, copy and
fill intervals over the window's wall time)."""


def read(name, ctx):
    s = ctx["summary"]
    if s["window_s"] <= 0 or not s["device"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
