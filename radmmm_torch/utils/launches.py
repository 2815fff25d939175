"""The kernel wrappers' launch counts: one registry for every kernel.

A wrapper calls ``launched(name)`` where it launches its kernel on the
card, and nowhere else; its CPU twin counts nothing. ``chip_smoke.py`` and
the tests read ``launch_counts`` (a ``collections.Counter``, so a kernel
not launched yet reads 0). ``utils/graphs.py`` takes back what a capture
counted and adds it again at each replay, over the whole registry, so a
kernel added later needs no entry anywhere else.
"""
from __future__ import annotations

import collections

# kernel launches since the last ``clear()``, by kernel name
launch_counts: collections.Counter = collections.Counter()


def launched(name: str) -> None:
    """One launch of kernel ``name``."""
    launch_counts[name] += 1
