"""The program's own records of the traced window: the spans and counters
of ``radmmm_torch.utils.profiling``, which record only while a profiler
runs, so in a run only inside the traced window. A program without them
reads as no records."""


def records(name):
    """The records named ``name``."""
    from radmmm_torch.utils import profiling
    read = getattr(profiling, "records", None)
    return [] if read is None else [r for r in read() if r.name == name]
