"""mfu.<kind>: the operations of the traced window's work (the
benchmark's own count at the valid lengths, ``portbench/bounds.py``) over
the window's seconds, as a share of the H100's f32 peak."""
from portbench.bounds import PEAK_F32_FLOP_PER_S


def read(name, ctx):
    s = ctx["summary"]
    if not ctx.get("flops") or s["window_s"] <= 0:
        return None
    return 100.0 * ctx["flops"] / s["window_s"] / PEAK_F32_FLOP_PER_S
