"""bucket_pad_pct.<kind>: 100 x (the frame buckets' frames - the frames
the requests needed) / the buckets' frames, summed over the traced
window's calls, from the port's counters ``serve.frames_bucket`` and
``serve.frames_needed`` (``serving.load_tts``)."""
from portbench import harness

_program = harness.load_module(harness.ROOT / "metrics" / "program.py",
                               "portbench_metric_program")


def read(name, ctx):
    bucket = sum(r.value for r in _program.records("serve.frames_bucket"))
    need = sum(r.value for r in _program.records("serve.frames_needed"))
    if bucket <= 0:
        return None
    return 100.0 * (bucket - need) / bucket
