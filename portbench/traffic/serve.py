"""Serving traffic: closed-loop clients calling the port's
``server.TTSService.synthesize`` with token ids, over an artifact that the
port's ``serving.export_tts`` writes and ``load_tts`` loads (capturing
every bucket's CUDA graphs at load).

Parameters (the cell's ``traffic``):

- ``clients``: closed-loop clients, each a thread that sends its next
  request when its last returns (``DeviceDispatcher`` orders the device
  work of all of them);
- ``texts``: texts a request; ``seconds`` {min, mode, max}: the
  triangular distribution of an utterance's spoken seconds, and
  ``tokens_per_second``: its text tokens a second. A text's token count
  is taken at the distribution's quantiles, the same BLOCK of them in
  every block of requests;
- ``requests``: requests made from the seed and cycled;
- ``buckets``: the artifact's (batch, text) buckets; ``frame_buckets``:
  its mel-frame buckets;
- ``sample``: requests whose outputs the reference checks after the
  window (drawn from the seed among those served, with the longest).

Each request draws its speaker, accent and latent seed from the run's
seed. The artifact is written to an in-memory file (``memfd``), not to
disk: a run writes next to nothing.
"""
from __future__ import annotations

import gc
import os
import sys
import threading
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import bounds, harness, weights
from portbench.reference import serve as ref_serve
from portbench.reference.frozen.models.tts import TTSConfig, TTSModel

WARMUP_REQUESTS = 3


# texts a block of requests: every block holds the same token counts
# (the distribution's quantiles) in an order drawn from the seed, so any
# run of whole blocks does the same work whatever the seed. With 25, the
# 50th and 95th percentiles of a window's requests fall inside one count's
# share of them (positions 12.5 and 23.75 of 25), not between two.
BLOCK = 25


def triangular_quantile(u: float, lo: float, mode: float, hi: float
                        ) -> float:
    """The u-quantile of the triangular distribution over [lo, hi] with
    its peak at ``mode``."""
    cut = (mode - lo) / (hi - lo)
    if u < cut:
        return lo + np.sqrt(u * (hi - lo) * (mode - lo))
    return hi - np.sqrt((1 - u) * (hi - lo) * (hi - mode))


def token_counts(p: Dict[str, Any], n: int) -> List[int]:
    """n text lengths in tokens at the quantiles of the spoken-seconds
    distribution, at ``tokens_per_second``."""
    s = p["seconds"]
    return [max(1, int(round(p["tokens_per_second"] * triangular_quantile(
        (i + 0.5) / n, s["min"], s["mode"], s["max"])))) for i in range(n)]


def make_requests(p: Dict[str, Any], cs: Dict[str, Any], seed: int
                  ) -> List[Dict[str, Any]]:
    """The cell's requests from ``seed``: the same seed gives the same
    requests; every block of BLOCK requests has the same text lengths."""
    rng = np.random.default_rng([int(seed), 13])
    tts = cs["tts"]
    per = int(p["texts"])
    sizes = token_counts(p, BLOCK * per)
    out = []
    for s in range(0, int(p["requests"]), BLOCK):
        order = rng.permutation(len(sizes))
        for r in range(min(BLOCK, int(p["requests"]) - s)):
            lens = [sizes[order[r * per + j]] for j in range(per)]
            texts = [rng.integers(1, tts["n_text_tokens"], n).tolist()
                     for n in lens]
            b = len(texts)
            out.append({
                "text_ids": texts,
                "speaker_id": rng.integers(0, tts["n_speakers"], b).tolist(),
                "accent_id": rng.integers(0, tts["n_accents"], b).tolist(),
                "f0_mean": [5.0] * b, "f0_std": [0.3] * b,
                "seed": int(rng.integers(0, 2 ** 31))})
    return out


class Artifact:
    """The serving artifact of the benchmark's weights, exported by the
    port into an in-memory file; ``path`` names it while open."""

    def __init__(self, cs: Dict[str, Any], seed: int, p: Dict[str, Any],
                 device):
        from radmmm_torch.models.tts import TTSConfig as PortConfig
        from radmmm_torch.models.tts import TTSModel as PortModel
        from radmmm_torch.serving import export_tts
        from radmmm_torch.vocoder.hifigan import Generator as PortGenerator
        from radmmm_torch.vocoder.hifigan import (HiFiGANConfig as
                                                  PortVocoderConfig)
        made = ref_serve.states(cs, seed, device)
        with torch.device(device):
            model = PortModel(PortConfig(**cs["tts"]))
            voc = PortGenerator(PortVocoderConfig.from_dict(cs["vocoder"]))
        model.load_state_dict(made["tts_state"])
        voc.load_state_dict(made["vocoder_state"])
        del made
        self.fd = os.memfd_create("portbench-artifact")
        self.path = f"/proc/self/fd/{self.fd}"
        export_tts(model, self.path, vocoder=voc,
                   sigma=float(cs["serving"]["sigma"]),
                   buckets=[tuple(b) for b in p["buckets"]],
                   frame_buckets=tuple(p["frame_buckets"]))

    def close(self) -> None:
        os.close(self.fd)


def run(cell: Dict[str, Any], seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", hooks=None) -> Dict[str, Any]:
    """One run of a serving cell (see the module docstring). ``hooks``
    (tests) may wrap the service: ``hooks["service"](service)`` -> an
    object with ``synthesize``."""
    from radmmm_torch.server import TTSService
    cs, p = cell["config_spec"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    hop = int(cs["serving"]["hop_length"])
    sr = int(cs["serving"]["vocoder_sampling_rate"])
    frame_buckets = sorted(int(f) for f in p["frame_buckets"])

    mark = harness.Marks(t0)
    mark("imported")
    reqs = make_requests(p, cs, seed)
    art = Artifact(cs, seed, p, dev)
    mark("artifact exported")
    try:
        service = TTSService(art.path, sampling_rate=sr, hop_length=hop,
                             device=device)
    finally:
        art.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mark("artifact loaded, its graphs captured")
    svc = service if hooks is None else hooks["service"](service)
    for r in reqs[:WARMUP_REQUESTS]:
        svc.synthesize(r)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    done: List[Dict[str, Any]] = []
    failures: List[str] = []
    lock = threading.Lock()
    counter = [WARMUP_REQUESTS]

    def client(win: harness.Window, traced: bool):
        while win.running():
            with lock:
                k = counter[0] % len(reqs)
                counter[0] += 1
            req = reqs[k]
            a = time.perf_counter()
            try:
                if traced:
                    with torch.profiler.record_function(
                            "portbench.request"):
                        items, lens = svc.synthesize(req)
                else:
                    items, lens = svc.synthesize(req)
            except Exception as e:  # a request that fails is counted
                with lock:
                    failures.append(f"request {k}: {e!r}")
                continue
            b = time.perf_counter()
            with lock:
                done.append({"k": k, "ms": (b - a) * 1e3, "end": b,
                             "pcm": items, "frames": [int(x) for x in lens]})

    def window(win: harness.Window, traced: bool = False):
        # one client runs on this thread (the profiler records the spans
        # of the thread that started it)
        threads = [threading.Thread(target=client, args=(win, traced))
                   for _ in range(int(p["clients"]) - 1)]
        win.open()
        for t in threads:
            t.start()
        client(win, traced)
        for t in threads:
            t.join()
        sync()
        if not done:
            raise RuntimeError("no request of the window was answered: "
                               + "; ".join(failures[:3]))
        return max(d["end"] for d in done) - win.t0

    setup_s = time.perf_counter() - t0
    ctx = None
    if trace:
        win = harness.Window(min(seconds, harness.TRACE_SECONDS), sync)
        wall, summary = harness.profiled(lambda: window(win, True),
                                         win.seconds, sync)
        summary["window_s"] = wall
        ctx = trace_context(cs, p, summary, done, reqs, frame_buckets)
    else:
        wall = window(harness.Window(seconds, sync))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for line in failures[:5]:
        print(f"failed {line}", file=sys.stderr)
    ms = [d["ms"] for d in done]
    print("latency ms " + ", ".join(
        f"p{q} {harness.percentile(ms, q):.3f}" for q in (10, 50, 90, 95, 99,
                                                          100))
          + f" over {len(ms)} requests; frames a token "
          + f"{sum(sum(d['frames']) for d in done) / max(1, sum(len(t) for d in done for t in reqs[d['k']]['text_ids'])):.3f}",
          file=sys.stderr)
    samples = sum(len(x) for d in done for x in d["pcm"])
    e2e = {"request_p50_ms": harness.percentile(ms, 50),
           "request_p95_ms": harness.percentile(ms, 95),
           "audio_s_per_s": samples / sr / wall, "setup_s": setup_s}

    service._dispatch.close()
    del service, svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    nums = check(cs, p, seed, done, reqs, frame_buckets, dev)
    limits = cell["limits"]
    checks = [harness.judged(k, nums[k], limits[k]) for k in limits]
    # every request sent has to be answered: one that fails makes the
    # run not correct
    checks.append(harness.judged("failed_requests", len(failures), 0))
    return {"checks": checks, "attempted": len(done) + len(failures),
            "failed": len(failures),
            "e2e": e2e, "ctx": ctx, "peak_bytes": peak, "numbers": nums}


def sampled(done: List[Dict[str, Any]], n: int, seed: int) -> List[Dict]:
    """``n`` served requests drawn from ``seed``, the one with the most
    frames among them."""
    rng = np.random.default_rng([int(seed), 17])
    longest = max(range(len(done)), key=lambda i: max(done[i]["frames"]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(pick)]


def check(cs, p, seed, done, reqs, frame_buckets, dev) -> Dict[str, float]:
    ref = ref_serve.Reference(cs, seed, dev)
    picked = sampled(done, int(p["sample"]), seed)
    bucket = p["buckets"][0]
    refs = [ref(reqs[d["k"]], bucket, frame_buckets) for d in picked]
    return ref_serve.serve_numbers(picked, refs)


def trace_context(cs, p, summary, done, reqs, frame_buckets) -> Dict:
    """What the per-layer readers of a serving cell read: the trace, the
    requests, their operations, K4's bounds and the frame padding."""
    frozen = weights.build_on("meta", TTSModel, TTSConfig(**cs["tts"]))
    table = bounds.model_macs_per_step(frozen)
    group = int(cs["flops"]["group"])
    B, T_text = p["buckets"][0]
    flops = lstm = 0.0
    pads = []
    for d in done:
        req = reqs[d["k"]]
        n_tok = [len(s) for s in req["text_ids"]]
        ls = list(zip(n_tok, d["frames"]))
        need = max(d["frames"])
        F = next((f for f in frame_buckets if f >= need), frame_buckets[-1])
        pads.append(100.0 * (F - min(need, F)) / F)
        flops += bounds.tts_flops(table, cs["flops"], ls, inference=True)
        flops += bounds.hifigan_flops(cs["vocoder"], d["frames"])
        for launch in cs["lstm_launches"]:
            axis = launch["axis"]
            T = bounds.axis_length(axis, T_text, F, group)
            valid = sum(bounds.axis_length(axis, n, m, group)
                        for n, m in ls)
            lstm += bounds.bound_ms(int(launch["lanes"]), T, B,
                                    int(launch["hidden"]), valid)
    return {"kind": "serve", "summary": summary, "units": len(done),
            "flops": flops, "bound_ms": {"lstm": lstm},
            "frame_pad": pads}
