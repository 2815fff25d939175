"""Threaded prefetching data loader.

Counterpart of ``radmmm_tpu/data/loader.py``. A thread pool loads and
augments items (host work), batches are collated on the host and, when a
featurizer is given, featurized on its device, and a small queue keeps the
next batches ready. Broken items (None) are dropped, as the reference's
collate drops them.

Over several processes (``process_count`` > 1, by default the data group
of the active ``parallel.mesh``: ranks of one model group load the same
batches) each epoch's batches are grouped by scheduled (B, frames, text)
shape and dealt to the processes in rounds within each group, so every
process runs the same number of steps at the same shapes, each batch
padded to its round's shape; batches that cannot fill a round are dropped
(a warning on process 0), as the JAX package deals them. Validation
loaders (``uniform_shape``) then schedule one shape for the whole set.

With ``shape_runs=k`` each epoch's batches are reordered so that batches of
one scheduled (B, frames, text) shape come out in consecutive runs of up to
k, each padded to the scheduled shape: the trainer's group of k steps
(``training/loop.py``) then gets k batches of one shape. The run order is
shuffled by its own generator, seeded ``seed ^ 0x5EED`` as in the JAX
package, so both run the same batches in the same order.
"""
from __future__ import annotations

import queue
import sys
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from radmmm_torch.data.collate import BucketBatcher, collate_host, round_up
from radmmm_torch.parallel import mesh


def stack_raw_batches(raws):
    """Stack K same-shape ``Featurizer.raw_arrays`` dicts along a new
    leading axis."""
    return {k: np.stack([r[k] for r in raws]) for k in raws[0]}


# seconds a consumer that stops early waits for the producer to finish the
# item in hand and end, before it raises with the producer's stack
JOIN_TIMEOUT_S = 120.0


def _producer_stack(t: threading.Thread) -> str:
    frame = sys._current_frames().get(t.ident)
    return "".join(traceback.format_stack(frame)) if frame else "(ended)"


def _threaded(produce: Callable[[Callable], None], depth: int) -> Iterable:
    """Run ``produce(put)`` in a daemon thread and yield what it puts. An
    exception in the producer is raised in the consumer; a consumer that
    stops early (a break, an abandoned ``next(iter(...))``) releases the
    producer, which then ends instead of blocking on a full queue, and
    waits for it: a producer still featurizing on the card when the
    process exits aborts it.

    No wait is without end: the consumer checks every second that the
    producer is alive, and waits at most JOIN_TIMEOUT_S for it to end,
    then raises with the producer's stack. A generator closed on its own
    producer's thread (the garbage collector may finalise it on any
    thread) does not wait for itself."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            produce(put)
        except BaseException as e:  # raised again in the consumer
            put(e)
        finally:
            put(sentinel)

    def join():
        if t is threading.current_thread():
            return
        t.join(JOIN_TIMEOUT_S)
        if t.is_alive():
            raise RuntimeError(
                f"the loader's producer thread {t.name} did not end within "
                f"{JOIN_TIMEOUT_S:g} s of its consumer's stop; it is at:\n"
                + _producer_stack(t))

    t = threading.Thread(target=run, daemon=True, name="loader-producer")
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                if not t.is_alive() and q.empty():
                    raise RuntimeError("the loader's producer thread ended "
                                       "without its end-of-data mark")
                continue
            if item is sentinel:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        join()
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
        join()


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 featurizer: Optional[Callable] = None,
                 num_threads: int = 4, prefetch: int = 2, seed: int = 0,
                 hop_length: int = 256, uniform_shape: bool = False,
                 shape_runs: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.featurizer = featurizer
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.hop_length = hop_length
        if process_count is None:
            m = mesh.get_mesh()
            process_index, process_count = m.data_index, m.n_data
        self.process_index = process_index or 0
        self.process_count = max(1, process_count)
        self._seed = seed
        self.batcher = BucketBatcher([u.duration for u in dataset.data],
                                     batch_size, shuffle, seed)
        self.shape_runs = int(shape_runs)
        self._runs_rng = np.random.default_rng(seed ^ 0x5EED)
        self._uniform_shape = False
        self._warned_drop = False
        if self.process_count > 1 or self.shape_runs > 0:
            # shapes scheduled from filelist metadata: mel frames from the
            # durations (scaled by the largest duration stretch an
            # augmentation can apply, so pad_to always covers it), text
            # tokens from one encode pass
            sr = getattr(dataset, "sampling_rate", 22050)
            aug = getattr(dataset, "augmentations", None)
            dur_factor = (aug.max_duration_factor()
                          if aug is not None else 1.0)
            self._sched_frames = np.array(
                [1 + int(np.ceil(u.duration * dur_factor * sr))
                 // self.hop_length for u in dataset.data], np.int64)
            self._sched_text = np.array(
                [dataset.encoded_text_length(i)
                 for i in range(len(dataset.data))], np.int64)
            self._uniform_shape = uniform_shape

    def __len__(self):
        """Batches this process yields an epoch. Over several processes:
        counted on a same-seed copy of the batcher, so the dropped rounds
        are left out (exact for the first epoch; later epochs reshuffle)."""
        if self.process_count == 1:
            return len(self.batcher)
        if not hasattr(self, "_len_cache"):
            clone = BucketBatcher(self.batcher.lengths,
                                  self.batcher.batch_size,
                                  self.batcher.shuffle, self._seed)
            counts: dict = {}
            for indices in clone:
                key = self._shape_key(np.asarray(indices))
                counts[key] = counts.get(key, 0) + 1
            self._len_cache = sum(n // self.process_count
                                  for n in counts.values())
        return self._len_cache

    def _shape_key(self, indices):
        sel = slice(None) if self._uniform_shape else indices
        frames = round_up(int(self._sched_frames[sel].max()), 64)
        text = round_up(int(self._sched_text[sel].max()), 16)
        return (len(indices), frames, text)

    def _batches(self):
        """Yield (indices, pad_to) for this process: in one process every
        batch at its natural bucket shape, or, with ``shape_runs``, grouped
        by scheduled shape into runs of up to ``shape_runs`` in a shuffled
        run order, each batch padded to its run's shape; over several, the
        deal in rounds (``_dealt``)."""
        if self.process_count > 1:
            yield from self._dealt()
            return
        if self.shape_runs <= 0:
            for indices in self.batcher:
                yield indices, None
            return
        by_key: dict = {}
        for indices in self.batcher:
            indices = np.asarray(indices)
            by_key.setdefault(self._shape_key(indices), []).append(
                list(map(int, indices)))
        runs = [(key, batches[i:i + self.shape_runs])
                for key, batches in by_key.items()
                for i in range(0, len(batches), self.shape_runs)]
        if self.batcher.shuffle:
            self._runs_rng.shuffle(runs)
        for key, batches in runs:
            for indices in batches:
                yield indices, key[1:]

    def _dealt(self):
        """Batches grouped by scheduled shape; each time a shape has one
        batch for every process, process i takes the i-th. With
        ``shape_runs`` the completed rounds of a shape are buffered into
        runs of that many, so every process ends its runs at the same
        steps; partial runs come out at the epoch's end."""
        pending: dict = {}
        runs_pending: dict = {}
        for indices in self.batcher:
            indices = np.asarray(indices)
            key = self._shape_key(indices)
            group = pending.setdefault(key, [])
            group.append(indices)
            if len(group) < self.process_count:
                continue
            mine = list(map(int, group[self.process_index]))
            pending[key] = []
            if self.shape_runs <= 0:
                yield mine, key[1:]
                continue
            run = runs_pending.setdefault(key, [])
            run.append(mine)
            if len(run) == self.shape_runs:
                for m in run:
                    yield m, key[1:]
                runs_pending[key] = []
        for key, run in runs_pending.items():
            for m in run:
                yield m, key[1:]
        dropped = sum(len(g) for g in pending.values())
        if dropped and not self._warned_drop and self.process_index == 0:
            self._warned_drop = True
            print(f"DataLoader: dropped {dropped} tail batch(es)/epoch that "
                  f"couldn't fill a {self.process_count}-process round "
                  "(shape-grouped multi-process scheduling)")

    def _load_batch(self, pool, indices, pad_to=None):
        items = list(pool.map(self.dataset.__getitem__, indices))
        if pad_to is not None:
            # a scheduled shape keeps B: a broken item is replaced by a
            # repeat of a good one instead of dropped
            good = [x for x in items if x is not None]
            if not good:
                raise RuntimeError(
                    f"all items broken in batch {list(indices)}")
            items = [x if x is not None else good[0] for x in items]
        host = collate_host(items, hop_length=self.hop_length,
                            pad_to=pad_to)
        if host is None:
            return None
        return self.featurizer(host) if self.featurizer else host

    def first_batch(self):
        """The epoch's first batch, loaded as the JAX package's trainer
        loads it with ``next(iter(loader))``: the loader's thread there is
        left running and goes on until its queue is full, so the batches
        that fill the queue, and one more, are loaded too, each drawing
        its augmentations from the dataset's generator and featurized.
        The same batches are loaded here, in this thread, and dropped, so
        the next loader's draws start where the JAX package's do."""
        first, last = None, None
        with ThreadPoolExecutor(self.num_threads) as pool:
            for i, (indices, pad_to) in enumerate(self._batches()):
                batch = self._load_batch(pool, indices, pad_to)
                if first is None and batch is not None:
                    first, last = batch, i + self.prefetch + 1
                if last is not None and i >= last:
                    break
        if first is None:
            raise RuntimeError("the training set gave no batch")
        return first

    def __iter__(self) -> Iterable:
        def produce(put):
            with ThreadPoolExecutor(self.num_threads) as pool:
                for indices, pad_to in self._batches():
                    batch = self._load_batch(pool, indices, pad_to)
                    if batch is not None and not put(batch):
                        return

        yield from _threaded(produce, self.prefetch)


def prefetch_raw_groups(loader, featurizer, k: int, device, depth: int = 2):
    """Yield groups of up to ``k`` consecutive same-shape raw batches
    (``featurizer.raw_arrays`` of the loader's host batches, int16 audio),
    each ``stack_raw_batches`` of them as tensors on ``device`` (batch i of
    a group is row i of each). A thread stacks and uploads each group
    ``depth`` groups ahead, from pinned memory on the card, so the upload
    rides under the previous group's steps. A group ends where the shape
    changes or at k batches, as in the JAX package."""

    def upload(pending):
        on = {}
        for key, a in stack_raw_batches(pending).items():
            t = torch.from_numpy(a)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            on[key] = t
        return on

    def produce(put):
        pending, pshape = [], None
        for host in loader:
            raw = featurizer.raw_arrays(host)
            shape = (raw["audio_i16"].shape, raw["text"].shape)
            if pending and (shape != pshape or len(pending) == k):
                if not put(upload(pending)):
                    return
                pending = []
            pending.append(raw)
            pshape = shape
        if pending:
            put(upload(pending))

    yield from _threaded(produce, depth)
