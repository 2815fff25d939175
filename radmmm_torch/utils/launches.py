"""The kernel wrappers' launch counts: one registry for every kernel.

A wrapper calls ``launched(name)`` where it launches its kernel on the
card, and nowhere else; its CPU twin counts nothing. ``chip_smoke.py`` and
the tests read ``launch_counts`` (a ``collections.Counter``, so a kernel
not launched yet reads 0).

``TALLIES`` holds every host-side counter that ticks where a call queues
work on the card: ``launch_counts`` first, then what other modules append
(the collectives' counts and bytes). ``utils/graphs.py`` takes back what
a capture counted in each of them and adds it again at each replay, so a
kernel or a counter added later needs no entry there.
"""
from __future__ import annotations

import collections
from typing import List

# kernel launches since the last ``clear()``, by kernel name
launch_counts: collections.Counter = collections.Counter()

TALLIES: List[collections.Counter] = [launch_counts]


def launched(name: str) -> None:
    """One launch of kernel ``name``."""
    launch_counts[name] += 1
