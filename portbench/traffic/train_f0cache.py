"""Training traffic with the F0 from a cache: clips at a cited length
distribution, length-sorted into batches that each keep their natural
bucket shape, stepped through the port's graphed featurize + train step
(``make_train_step(binarize=True, kl_on=True, featurizer=...)`` in a
``GraphPool``), each step's batch uploaded from pinned memory as the
loader's prefetch does. The step featurizes mel, energy and the prior;
the F0 comes from the cache that set-up fills with the port's
``build_f0_cache`` (pYIN on the device), so no pYIN runs in the window.

Parameters (the cell's ``traffic``):

- ``clips``: utterances, at the quantiles (i + 0.5) / clips of the
  triangular distribution ``seconds`` {min, mode, max} of a clip's
  seconds, with ``tokens_per_second`` tokens of text each (ids drawn from
  the seed), all of speaker ``speaker`` and accent ``accent``;
- ``batch``: consecutive clips a batch; each batch padded to its own
  shape: frames to a multiple of ``frames_multiple`` and tokens to one of
  ``text_multiple``, as the port's loader buckets them.

Every seed gets the same clip lengths, so the same batches and shapes;
the seed draws the audio, the text and the order in which the window
cycles the batches.

Set-up runs the COMPARED_STEPS steps that the reference follows: first
the five longest batches but three at the most common shape (RAdam's
unrectified branch, one eager warm-up a shape), then those three at the
most common shape (the rectified branch that the window replays: its
warm-up, its capture, which replays, and a plain replay). It then goes on
through the window's order until every shape has been captured in the
rectified branch.
"""
from __future__ import annotations

import gc
import itertools
import os
import tempfile
import time
from collections import Counter
from types import SimpleNamespace
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import audio, bounds, compare, harness, weights
from portbench.reference import train_f0cache as ref
from portbench.reference.frozen.data.collate import collate_host
from portbench.reference.radtts import TTSConfig, TTSModel
from portbench.reference.train import COMPARED_STEPS

_train = harness.traffic_kind("train")
# the steps at the rectified graph's shape among the compared ones
RECTIFIED_STEPS = 3


def make_items(p: Dict[str, Any], cs: Dict[str, Any], seed: int) -> list:
    """The cell's clips from ``seed``, shortest first."""
    tri = harness.traffic_kind("serve").triangular_quantile
    rng = np.random.default_rng([int(seed), 11])
    sr = int(cs["featurizer"]["sampling_rate"])
    s = p["seconds"]
    n = int(p["clips"])
    items = []
    for i in range(n):
        sec = tri((i + 0.5) / n, s["min"], s["mode"], s["max"])
        tokens = max(1, int(round(p["tokens_per_second"] * sec)))
        items.append(audio.item(rng, int(sec * sr), tokens,
                                cs["tts"]["n_text_tokens"], p["speaker"],
                                p["accent"], sr, i))
    return items


def make_batches(p: Dict[str, Any], cs: Dict[str, Any], items: list
                 ) -> List[Dict[str, Any]]:
    """Host batches of consecutive items, each at its own bucket shape."""
    B = int(p["batch"])
    hop = int(cs["featurizer"]["hop_length"])
    return [collate_host(items[s:s + B], hop_length=hop,
                         audio_frames_multiple=int(p["frames_multiple"]),
                         text_multiple=int(p["text_multiple"]))
            for s in range(0, len(items), B)]


class _Clips:
    """The items as ``data/f0_cache.build_f0_cache`` reads a dataset."""

    augmentations = None

    def __init__(self, items: list, sr: int):
        self.items, self.sampling_rate = items, sr
        self.data = [SimpleNamespace(duration=len(x["audio"]) / sr)
                     for x in items]

    def __getitem__(self, i):
        return self.items[i]


def f0_tracks(cs: Dict[str, Any], items: list, device) -> List[np.ndarray]:
    """Each item's (3, frames) [f0 Hz, voiced, p_voiced] track, through
    the port's F0 cache: built by ``build_f0_cache`` on ``device`` into a
    temporary file, then read back."""
    from radmmm_torch.data.f0_cache import build_f0_cache, f0_key
    from radmmm_torch.native import FeatureCache
    f = cs["featurizer"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "f0")
        build_f0_cache(_Clips(items, int(f["sampling_rate"])), path,
                       filter_length=f["filter_length"],
                       hop_length=f["hop_length"], f0_min=f["f0_min"],
                       f0_max=f["f0_max"], f0_method=f["f0_method"],
                       device=device)
        with FeatureCache(path) as cache:
            return [cache.get_array(f0_key(x["audiopath"])) for x in items]


def raw_batches(p, cs, items, tracks) -> List[Dict[str, np.ndarray]]:
    """The featurizer's raw arrays of every batch, each with its items'
    cached tracks padded to its frames (``cached_f0``, as the port's
    ``collate_host`` pads them)."""
    B = int(p["batch"])
    hop = int(cs["featurizer"]["hop_length"])
    out = []
    for b, host in enumerate(make_batches(p, cs, items)):
        raw = _train._raw(host)
        frames = raw["audio_i16"].shape[1] // hop
        cf = np.zeros((len(host["idx"]), 3, frames), np.float32)
        for i, t in enumerate(tracks[b * B:(b + 1) * B]):
            n = min(t.shape[1], frames)
            cf[i, :, :n] = t[:, :n]
        raw["cached_f0"] = cf
        out.append(raw)
    return out


def shape_of(raw) -> tuple:
    return raw["audio_i16"].shape, raw["text"].shape


def compared_batches(raws) -> List[int]:
    """The compared steps' batches: the five longest but RECTIFIED_STEPS
    batches at the most common shape, then those."""
    common = Counter(shape_of(r) for r in raws).most_common(1)[0][0]
    at = [k for k, r in enumerate(raws)
          if shape_of(r) == common][:RECTIFIED_STEPS]
    rest = sorted((k for k in range(len(raws)) if k not in at),
                  key=lambda k: -raws[k]["audio_i16"].size)
    first = COMPARED_STEPS - RECTIFIED_STEPS
    if len(at) < RECTIFIED_STEPS or len(rest) < first:
        raise ValueError(f"the compared steps take {RECTIFIED_STEPS} "
                         f"batches at one shape and {first} others; the "
                         f"traffic has {len(raws)} batches")
    return rest[:first] + at


def traffic(cell: Dict[str, Any], seed: int, device):
    """(raw batches with their cached F0, the compared steps' batches)."""
    cs, p = cell["config_spec"], cell["traffic"]
    items = make_items(p, cs, seed)
    raws = raw_batches(p, cs, items, f0_tracks(cs, items, device))
    return raws, compared_batches(raws)


class Program(_train.Program):
    """The port's training step as the trainer builds it, over the
    benchmark's weights drawn for this configuration."""

    def __init__(self, cs: Dict[str, Any], seed: int, device):
        from radmmm_torch.data.collate import Featurizer
        from radmmm_torch.models.tts import TTSConfig as PortConfig
        from radmmm_torch.models.tts import TTSModel as PortModel
        from radmmm_torch.training.step import (LossConfig,
                                                create_train_state,
                                                make_train_step)
        from radmmm_torch.utils.graphs import GraphPool
        sd = ref.model_state(cs, seed, device)["state"]
        with torch.device(device):
            model = PortModel(PortConfig(**cs["tts"]))
        model.load_state_dict(sd)
        del sd
        o = cs["optim"]
        self.state = create_train_state(
            model, device=device, optim_algo=o["optim_algo"],
            learning_rate=o["learning_rate"],
            weight_decay=o["weight_decay"], grad_clip_val=o["grad_clip_val"])
        self.model = model
        self.feat = Featurizer(**cs["featurizer"], device=device, pool=None)
        self.pool = GraphPool()
        self.step = make_train_step(model, LossConfig(**cs["loss"]), True,
                                    True, featurizer=self.feat,
                                    pool=self.pool)
        self.gen = torch.Generator(device=device).manual_seed(
            _train.dropout_seed(seed))


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", hooks=None) -> Dict[str, Any]:
    """One run of the cell (see the module docstring). ``hooks`` (tests)
    may wrap the program's step: ``hooks["step"](program)`` -> a callable
    taking a raw batch."""
    cs = cell["config_spec"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    hop = int(cs["featurizer"]["hop_length"])

    mark = harness.Marks(t0)
    mark("imported")
    raws, compared = traffic(cell, seed, dev)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    lens = [_train.lengths(r, hop) for r in raws]
    frames = [sum(m for _, m in ls) for ls in lens]
    pinned = [{k: (torch.from_numpy(v).pin_memory() if cuda
                   else torch.from_numpy(v)) for k, v in r.items()}
              for r in raws]
    order = np.random.default_rng([int(seed), 13]).permutation(len(raws))

    def upload(k):
        return {n: v.to(dev, non_blocking=True) for n, v in
                pinned[k].items()}

    mark("traffic and F0 cache made")
    prog = Program(cs, seed, dev)
    mark("program built")
    step = prog if hooks is None else hooks["step"](prog)
    prog.whiten(upload(compared[0]))
    names = [n for n, _ in prog.model.named_parameters()]
    reads = ref.Reads(names, prog.model.parameters())

    rectified_calls: Dict[tuple, int] = Counter()

    def set_up_step(k):
        met = step(upload(k))
        if prog.state.optimizer.rectified:
            rectified_calls[shape_of(raws[k])] += 1
        return met

    for k in compared:
        reads.before()
        reads.after(set_up_step(k), prog.state.optimizer)
    read = reads.finish()
    n_setup = len(compared)
    shapes = {shape_of(r) for r in raws}
    for k in itertools.cycle(order):
        if all(rectified_calls[s] >= 2 for s in shapes):
            break
        if rectified_calls[shape_of(raws[k])] < 2:
            set_up_step(k)
            n_setup += 1
    sync()
    mark(f"{n_setup} set-up steps")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    replays0 = prog.pool.replays

    def window(win: harness.Window, traced: bool = False):
        n = done = 0
        events = []
        win.open()
        while win.running():
            k = order[n % len(order)]
            if traced:
                with torch.profiler.record_function("portbench.step"):
                    step(upload(k))
            else:
                step(upload(k))
            done += frames[k]
            n += 1
            if cuda:
                e = torch.cuda.Event()
                e.record()
                events.append(e)
                if len(events) > _train.AHEAD:
                    events.pop(0).synchronize()
        return n, done, win.close()

    setup_s = time.perf_counter() - t0
    ctx = None
    if trace:
        win = harness.Window(min(seconds, harness.TRACE_SECONDS), sync)
        (n, done, wall), summary = harness.profiled(lambda: window(win, True),
                                                    win.seconds, sync)
        summary["window_s"] = wall
        steps = [order[s % len(order)] for s in range(n)]
        ctx = trace_context(cs, summary, raws, lens, steps,
                            prog.pool.replays - replays0, hop)
    else:
        n, done, wall = window(harness.Window(seconds, sync))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del prog, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = ref.run(cs, seed, [raws[k] for k in compared],
                  _train.dropout_seed(seed), dev)
    nums = compare.train_numbers(read, got)
    limits = cell["limits"]
    checks = [harness.judged(k, nums[k], limits[k]) for k in limits]
    return {"checks": checks, "attempted": n, "failed": 0,
            "e2e": {"train_frames_per_s": done / wall, "setup_s": setup_s},
            "ctx": ctx, "peak_bytes": peak, "numbers": nums}


def trace_context(cs, summary, raws, lens, steps, replays, hop) -> Dict:
    """What the per-layer readers of a training cell read: the trace, the
    steps (``steps``: each step's batch), their operations and their
    kernels' bounds."""
    model = weights.build_on("meta", TTSModel, TTSConfig(**cs["tts"]))
    table = bounds.model_macs_per_step(model)
    flops = lstm = dp = 0.0
    for k in steps:
        ls = lens[k]
        B, T_text = raws[k]["text"].shape
        T_mel = raws[k]["audio_i16"].shape[1] // hop
        flops += bounds.tts_flops(table, cs["flops"], ls, inference=False)
        lstm += _train.lstm_bound(cs, ls, T_text, T_mel, B, train=True)
        tl, ml = [a for a, _ in ls], [b for _, b in ls]
        dp += 2 * bounds.ctc_bound_ms(tl, ml) + bounds.mas_bound_ms(tl, ml)
    return {"kind": "train", "summary": summary, "units": len(steps),
            "flops": flops, "bound_ms": {"lstm": lstm, "dp": dp},
            "replays": replays}


def controls(cell: Dict[str, Any], seed: int, dev,
             faults: List[str]) -> Dict[str, Dict[str, float]]:
    """The upper readings of ``seed``: the reference in TF32 (the
    control) and with each fault of ``faults``, against the reference."""
    cs = cell["config_spec"]
    raws, compared = traffic(cell, seed, dev)
    raws = [raws[k] for k in compared]
    ds = _train.dropout_seed(seed)
    base = ref.run(cs, seed, raws, ds, dev)
    out = {}
    for what, kw in [("control_tf32", {"lower_precision": True})] + [
            (f, {"fault": f}) for f in faults]:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[what] = compare.train_numbers(ref.run(cs, seed, raws, ds, dev,
                                                  **kw), base)
    return out
