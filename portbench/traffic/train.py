"""Training traffic: a pool of seeded batches of voiced audio and text,
stepped back to back through the port's graphed featurize + train step
(``make_train_step(binarize=True, kl_on=True, featurizer=...)`` in a
``GraphPool``), each step's int16 batch uploaded from pinned memory as the
loader's prefetch does.

Parameters (the cell's ``traffic``):

- ``batch``: items a batch; ``pool``: batches made, cycled;
- ``frames`` [lo, hi] and ``text`` [lo, hi]: uniform valid mel frames
  and tokens an item, at the distribution's quantiles, one of each
  eighth a batch;
- ``pad_to`` [frames, tokens]: every batch padded to that one shape.

The featurizer tracks pitch with pYIN inside the step's graph.

Set-up runs the steps that the reference follows, COMPARED_STEPS of them
on as many different batches: RAdam's unrectified branch (its warm-up,
capture and replays), then the rectified branch that every step of the
window replays, through its warm-up, its capture (which replays) and a
plain replay. It then goes on until every shape of the pool has been
captured in the rectified branch.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import audio, bounds, compare, harness, weights
from portbench.reference import train as ref_train
from portbench.reference.frozen.data.collate import collate_host
from portbench.reference.frozen.models.tts import TTSConfig, TTSModel

COMPARED_STEPS = ref_train.COMPARED_STEPS
# events a step may run ahead of the device
AHEAD = 2


def _raw(host: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The featurizer's raw arrays of a host batch: the audio quantised
    to int16 (as the port's ``Featurizer.raw_arrays``), strings
    dropped."""
    raw = {k: v for k, v in host.items()
           if isinstance(v, np.ndarray) and k != "audio"}
    raw["audio_i16"] = np.clip(np.rint(host["audio"] * 32768.0),
                               -32768, 32767).astype(np.int16)
    return raw


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    """n sizes at the quantiles of a uniform distribution over [lo, hi]."""
    return np.floor(lo + (np.arange(n) + 0.5) / n * (hi + 1 - lo))


def _strata(sizes: np.ndarray, per: int, rng) -> np.ndarray:
    """Sorted ``sizes`` dealt into groups of ``per``, one from each of
    ``per`` strata a group, each stratum dealt in an order drawn from
    ``rng``: every group's sum is near the mean, whatever the order."""
    groups = len(sizes) // per
    strata = np.sort(sizes).reshape(per, groups)
    out = np.empty((groups, per))
    for j in range(per):
        out[:, j] = strata[j][rng.permutation(groups)]
    for g in range(groups):
        out[g] = out[g][rng.permutation(per)]
    return out.reshape(-1)


def make_items(p: Dict[str, Any], cs: Dict[str, Any], seed: int) -> list:
    """The cell's utterances from ``seed``: the same seed gives the same
    items, and every seed the same sizes (the distribution's quantiles)
    in another order, so the work does not change with the seed."""
    rng = np.random.default_rng([int(seed), 11])
    sr = int(cs["featurizer"]["sampling_rate"])
    hop = int(cs["featurizer"]["hop_length"])
    tts = cs["tts"]
    items = []
    B, n = int(p["batch"]), int(p["pool"]) * int(p["batch"])
    frames = _strata(_spread(*p["frames"], n), B, rng)
    tokens = _strata(_spread(*p["text"], n), B, rng)
    for i in range(n):
        samples = (int(frames[i]) - 1) * hop + int(rng.integers(hop))
        items.append(audio.item(rng, samples, int(tokens[i]),
                                tts["n_text_tokens"],
                                rng.integers(tts["n_speakers"]),
                                rng.integers(tts["n_accents"]), sr, i))
    return items


def make_batches(p: Dict[str, Any], cs: Dict[str, Any], items: list
                 ) -> List[Dict[str, Any]]:
    """Host batches of the items, in order, each padded to ``pad_to``."""
    B = int(p["batch"])
    hop = int(cs["featurizer"]["hop_length"])
    return [collate_host(items[s:s + B], hop_length=hop,
                         pad_to=tuple(p["pad_to"]))
            for s in range(0, len(items), B)]


def lengths(raw: Dict[str, np.ndarray], hop: int) -> List[tuple]:
    """(valid tokens, valid mel frames) of each item of a raw batch."""
    frames = raw["audio_i16"].shape[1] // hop
    mel = np.minimum(1 + raw["audio_lengths"] // hop, frames)
    return list(zip(raw["input_lengths"].tolist(), mel.tolist()))


class Program:
    """The port's training step as the trainer builds it, over the
    benchmark's weights."""

    def __init__(self, cs: Dict[str, Any], seed: int, device):
        from radmmm_torch.data.collate import Featurizer
        from radmmm_torch.models.tts import TTSConfig as PortConfig
        from radmmm_torch.models.tts import TTSModel as PortModel
        from radmmm_torch.training.step import (LossConfig,
                                                create_train_state,
                                                make_train_step)
        from radmmm_torch.utils.graphs import GraphPool
        drawn = ref_train.model_state(cs, seed, device)
        sd = drawn["state"]
        del drawn
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
            dropout_seed(seed))

    def whiten(self, raw: Dict[str, torch.Tensor]) -> None:
        from radmmm_torch.training.step import make_whitening_init
        make_whitening_init(self.model)(self.state,
                                        self.feat.featurize_raw(raw, None))

    def __call__(self, raw: Dict[str, torch.Tensor]):
        from radmmm_torch.training.step import step_inputs
        self.state, met = self.step(self.state,
                                    step_inputs(self.feat, raw, None),
                                    self.gen)
        return met


def dropout_seed(seed: int) -> int:
    return int(np.random.SeedSequence([int(seed), 3]).generate_state(1)[0])


def lstm_bound(cs, raw_lens, T_text, T_mel, B, train=True) -> float:
    """Σ of K4's (and in training K4-bwd's) bounds over one batch's
    launches."""
    group = int(cs["flops"]["group"])
    total = 0.0
    for launch in cs["lstm_launches"]:
        axis = launch["axis"]
        T = bounds.axis_length(axis, T_text, T_mel, group)
        valid = sum(bounds.axis_length(axis, n, m, group)
                    for n, m in raw_lens)
        L, H = int(launch["lanes"]), int(launch["hidden"])
        total += bounds.bound_ms(L, T, B, H, valid, save=train)
        if train:
            total += bounds.bound_bwd_ms(L, T, B, H, valid)
    return total


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", hooks=None) -> Dict[str, Any]:
    """One run of a training cell (see the module docstring). ``hooks``
    (tests) may wrap the program's step: ``hooks["step"](program)`` ->
    a callable taking a raw batch."""
    cs, p = cell["config_spec"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    hop = int(cs["featurizer"]["hop_length"])

    mark = harness.Marks(t0)
    mark("imported")
    items = make_items(p, cs, seed)
    hosts = make_batches(p, cs, items)
    raws = [_raw(h) for h in hosts]
    if len(raws) < COMPARED_STEPS:
        raise ValueError(f"the pool holds {len(raws)} batches; the "
                         f"{COMPARED_STEPS} compared steps take one each")
    lens = [lengths(r, hop) for r in raws]
    frames = [sum(m for _, m in ls) for ls in lens]
    pinned = [{k: (torch.from_numpy(v).pin_memory() if cuda
                   else torch.from_numpy(v)) for k, v in r.items()}
              for r in raws]

    def upload(i):
        return {k: v.to(dev, non_blocking=True) for k, v in
                pinned[i].items()}

    mark("traffic made")
    prog = Program(cs, seed, dev)
    mark("program built")
    step = prog if hooks is None else hooks["step"](prog)
    prog.whiten(upload(0))
    names = [n for n, _ in prog.model.named_parameters()]
    reads = ref_train.Reads(names, prog.model.parameters())

    # set-up: the compared steps first, then on until every shape has
    # been captured in the rectified branch (its second call there)
    rectified_calls: Dict[tuple, int] = {}
    shapes = {(r["audio_i16"].shape, r["text"].shape) for r in raws}
    i = 0
    while i < COMPARED_STEPS or any(rectified_calls.get(s, 0) < 2
                                    for s in shapes):
        k = i % len(raws)
        if i < COMPARED_STEPS:
            reads.before()
        met = step(upload(k))
        if i < COMPARED_STEPS:
            reads.after(met, prog.state.optimizer)
        if prog.state.optimizer.rectified:
            s = (raws[k]["audio_i16"].shape, raws[k]["text"].shape)
            rectified_calls[s] = rectified_calls.get(s, 0) + 1
        i += 1
    read = reads.finish()
    sync()
    mark(f"{i} set-up steps")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    replays0 = prog.pool.replays

    def window(win: harness.Window, traced: bool = False):
        n = done = 0
        events = []
        win.open()
        while win.running():
            k = (i + n) % len(raws)
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
                if len(events) > AHEAD:
                    events.pop(0).synchronize()
        return n, done, win.close()

    setup_s = time.perf_counter() - t0
    ctx = None
    if trace:
        win = harness.Window(min(seconds, harness.TRACE_SECONDS), sync)
        (n, done, wall), summary = harness.profiled(lambda: window(win, True),
                                                    win.seconds, sync)
        summary["window_s"] = wall
        ctx = trace_context(cs, summary, raws, lens, i, n,
                            prog.pool.replays - replays0, hop)
    else:
        n, done, wall = window(harness.Window(seconds, sync))
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del prog, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = ref_train.run(cs, seed, raws[:COMPARED_STEPS], dropout_seed(seed),
                        dev)
    nums = compare.train_numbers(read, ref)
    limits = cell["limits"]
    checks = [harness.judged(k, nums[k], limits[k]) for k in limits]
    return {"checks": checks, "attempted": n, "failed": 0,
            "e2e": {"train_frames_per_s": done / wall, "setup_s": setup_s},
            "ctx": ctx, "peak_bytes": peak, "numbers": nums}


def trace_context(cs, summary, raws, lens, first, n, replays, hop) -> Dict:
    """What the per-layer readers of a training cell read: the trace, the
    steps, their operations and their kernels' bounds."""
    frozen = weights.build_on("meta", TTSModel, TTSConfig(**cs["tts"]))
    table = bounds.model_macs_per_step(frozen)
    flops = lstm = dp = 0.0
    for s in range(n):
        k = (first + s) % len(raws)
        ls = lens[k]
        B, T_text = raws[k]["text"].shape
        T_mel = raws[k]["audio_i16"].shape[1] // hop
        flops += bounds.tts_flops(table, cs["flops"], ls, inference=False)
        lstm += lstm_bound(cs, ls, T_text, T_mel, B, train=True)
        tl, ml = [a for a, _ in ls], [b for _, b in ls]
        dp += 2 * bounds.ctc_bound_ms(tl, ml) + bounds.mas_bound_ms(tl, ml)
    return {"kind": "train", "summary": summary, "units": n,
            "flops": flops, "bound_ms": {"lstm": lstm, "dp": dp},
            "replays": replays}
