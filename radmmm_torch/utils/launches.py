"""The kernel wrappers' launch counts: one registry for every kernel.

A wrapper calls ``launched(name)`` where it launches its kernel on the
card, and nowhere else; its CPU twin counts nothing. ``chip_smoke.py`` and
the tests read ``launch_counts`` (a ``collections.Counter``, so a kernel
not launched yet reads 0).

``TALLIES`` holds every host-side counter that ticks where a call queues
work on the card: ``launch_counts`` first, then what other modules append
(the collectives' counts and bytes). Every tick goes through ``tally``.
While a CUDA graph is captured (``begin_capture`` to ``end_capture``,
driven by ``utils/graphs.py``, one capture at a time in the process), the
ticks of what goes into it go to the capture's record and not to the
counters, and ``utils/graphs.py`` adds that record at each replay: those
of the thread that captures and those made on a capturing stream (the
autograd engine runs a captured backward on its own thread, on the
capture's stream). Other threads' ticks (a loader's replays, an eager
launch) meanwhile reach the counters as ever. So a kernel or a counter
added later needs no entry there.
"""
from __future__ import annotations

import collections
import threading
from typing import List, Optional

import torch

# kernel launches since the last ``clear()``, by kernel name
launch_counts: collections.Counter = collections.Counter()

TALLIES: List[collections.Counter] = [launch_counts]

# the open capture's record, a Counter per tally by its id, and the mark
# of the thread that opened it
_capture: Optional[dict] = None
_local = threading.local()


def _into_capture() -> bool:
    return getattr(_local, "capturing", False) or (
        torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())


def tally(counter: collections.Counter, key, n: int = 1) -> None:
    """Add ``n`` to ``counter[key]`` (a counter of ``TALLIES``), or to the
    open capture's record where the tick goes into the graph."""
    record = _capture
    if record is not None and _into_capture():
        record.setdefault(id(counter), collections.Counter())[key] += n
    else:
        counter[key] += n


def begin_capture() -> None:
    """The ticks of what goes into a graph captured by this thread go to a
    record of their own from now."""
    global _capture
    _capture = {}
    _local.capturing = True


def end_capture() -> List[collections.Counter]:
    """The capture's ticks since ``begin_capture``, a Counter per tally in
    the order of ``TALLIES``; ticks reach the counters again."""
    global _capture
    record, _capture = _capture, None
    _local.capturing = False
    return [record.get(id(c), collections.Counter()) for c in TALLIES]


def add_record(record: List[collections.Counter]) -> None:
    """Add ``end_capture``'s record to the counters (a replay's ticks)."""
    for c, r in zip(TALLIES, record):
        c.update(r)


def launched(name: str) -> None:
    """One launch of kernel ``name``."""
    tally(launch_counts, name)
