#!/usr/bin/env python3
"""Smoke run of the radmmm_torch serving path on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,serve,parity] [--seed 0]

Phases (all by default):

1. build    compile csrc/lstm_recurrence.cu for sm_90a into build/ and
            print the build time and the card's name and power limit;
2. kernels  the LSTM recurrence kernel against its plain PyTorch twin at
            the four shapes of the serving path (TextEncoder BiLSTM H=260,
            duration DAP H=128, six ganged frame-DAP lanes H=128, flow
            context BiLSTM H=528 with input 1060), B=1 and B=8, ragged
            masks, TF32 off; times of kernel, twin, cuDNN nn.LSTM and the
            card's lower bound for the same work;
3. serve    the full-width RADMMM model and HiFi-GAN v1 (22,050 Hz) with
            random weights from --seed, exported as a serving artifact,
            served over HTTP by radmmm_torch.server on 127.0.0.1; four
            requests (batch 1 and 3, 12 to 96 tokens, WAV output) are
            checked and the kernel's launches on them counted;
4. parity   one 12-token request through stage A+B at sigma=0, mel only,
            on the card and on the CPU: stage A compared on its float
            outputs, stage B on the same integer durations.

Any failure exits non-zero. The line before the last is a JSON object
with the kernel's numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import http.client
import io
import json
import math
import struct
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

PHASES = ("build", "kernels", "serve", "parity")
# (name, lanes, hidden, time steps, LSTM input width) on the serving path
# at text bucket 96 and frame bucket 800 (the flow context runs at 800/2)
PATH_SHAPES = (("text_encoder", 2, 260, 96, 520),
               ("duration_dap", 2, 128, 96, 256),
               ("frame_daps_ganged", 6, 128, 800, 256),
               ("flow_context", 2, 528, 400, 1060))
KERNEL_ATOL = 1e-5
PARITY_ATOL = 1e-3
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
TEXT_BUCKETS = [(1, 32), (4, 96)]
FRAME_BUCKETS = (192, 384, 576, 800)
SR, HOP = 22050, 256


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    log(f"FAIL: {msg}")
    sys.exit(1)


@contextlib.contextmanager
def tf32_off():
    """Full f32 in matmuls and cuDNN convolutions inside; the previous
    settings (PyTorch's defaults: TF32 off in matmuls, on in cuDNN) come
    back after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_build():
    from radmmm_torch.ops import lstm_kernel
    t0 = time.perf_counter()
    lib = lstm_kernel.build(force=True)
    log(f"[build] {lib.name} built in {time.perf_counter() - t0:.2f} s")
    ptxas = lib.parent / "lstm_recurrence.ptxas.txt"
    for line in ptxas.read_text().splitlines():
        if "registers" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
        else f"nvidia-smi failed: {smi.stderr.strip()}")


def _lengths(T: int, B: int) -> torch.Tensor:
    if B == 1:
        return torch.tensor([T * 7 // 8])
    return torch.tensor([T - i * T // (B + 1) for i in range(B)])


def bound_ms(L, T, B, H, valid_frames) -> tuple:
    """Least time for the recurrence: each input read once, the output
    written once; 8H² FLOP per (lane, valid frame) for h @ Wh."""
    n_bytes = 4 * (L * T * B * 4 * H + T * B + L * H * 4 * H + L * T * B * H)
    flops = 8.0 * H * H * L * valid_frames
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@tf32_off()
def phase_kernels(seed: int) -> list:
    from radmmm_torch.ops.lstm_kernel import (lstm_recurrence,
                                              lstm_recurrence_reference)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, L, H, T, cin in PATH_SHAPES:
        for B in (1, 8):
            lens = _lengths(T, B)
            mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
            xp = torch.randn((L, T, B, 4 * H), generator=gen, device=dev)
            wh = (torch.rand((L, H, 4 * H), generator=gen, device=dev)
                  * 2 - 1) / H ** 0.5
            rev = [bool(l % 2) for l in range(L)]
            got = lstm_recurrence(xp, mask, wh, rev)
            want = lstm_recurrence_reference(xp, mask, wh, rev)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            k_ms = cuda_ms(lambda: lstm_recurrence(xp, mask, wh, rev), 20)
            p_ms = cuda_ms(
                lambda: lstm_recurrence_reference(xp, mask, wh, rev), 2)
            # cuDNN yardstick: L/2 bidirectional nn.LSTM calls over packed
            # sequences of the layer's real input (its x @ W_ih included)
            lstms = [torch.nn.LSTM(cin, H, bidirectional=True).to(dev)
                     for _ in range(L // 2)]
            x = torch.randn((T, B, cin), generator=gen, device=dev)
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x, lens, enforce_sorted=False)

            def library():
                for m in lstms:
                    m(packed)
            with torch.no_grad():
                lib_ms = cuda_ms(library, 10)
            b_ms, b_by = bound_ms(L, T, B, H, int(lens.sum()))
            row = dict(shape=name, L=L, H=H, T=T, B=B, max_abs_err=err,
                       ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                       bound_ms=b_ms, bound_by=b_by)
            log(f"[kernels] {name} L={L} H={H} T={T} B={B}: max_abs_err "
                f"{err:.3e} (atol {KERNEL_ATOL:g}), kernel_ms {k_ms:.4f}, "
                f"plain_ms {p_ms:.3f}, library_ms {lib_ms:.4f}, bound_ms "
                f"{b_ms:.5f} ({b_by})")
            if not err <= KERNEL_ATOL:
                fail(f"kernel disagrees with its twin at {name} B={B}")
            rows.append(row)
    return rows


def build_models(seed: int):
    """Full-width RADMMM + HiFi-GAN v1 with random weights from ``seed``.
    The couplings' zero-initialised output convs get small random weights
    so the context reaches the mel (at init they make every coupling the
    identity), and the duration head's bias is log(1 + 7), which puts
    token durations at a few frames, the pace of speech at 22,050 Hz with
    hop 256, so the requests spread over the frame buckets as real text
    does (at init most tokens round to one frame)."""
    from radmmm_torch.models.tts import TTSModel, default_radmmm_config
    from radmmm_torch.ops.coupling import WN
    from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
    torch.manual_seed(seed)
    model = TTSModel(default_radmmm_config()).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WN):
                m.end.weight.normal_(0.0, 1e-3)
                m.end.bias.normal_(0.0, 1e-3)
        model.duration_predictor.backbone.dense.bias.fill_(math.log(8.0))
    vocoder = Generator(HiFiGANConfig()).eval()
    return model, vocoder


def _post(addr, body):
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        conn.request("POST", "/tts", body=json.dumps(body).encode())
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _wavs(blob: bytes, n_items: int):
    if n_items == 1:
        return [blob]
    out, off = [], 0
    while off < len(blob):
        (n,) = struct.unpack_from("<I", blob, off)
        out.append(blob[off + 4:off + 4 + n])
        off += 4 + n
    return out


def phase_serve(seed: int, model, vocoder, model_gpu) -> int:
    from radmmm_torch.ops import lstm_kernel
    from radmmm_torch.serving import (_pad_request, export_tts,
                                      make_two_stage_fns)
    from radmmm_torch.server import serve

    rng = np.random.default_rng(seed)
    # (token counts, speaker ids, accent ids, f0 means, f0 stds, seed)
    plan = [([12], [0], [0], [5.0], [0.3], 1),
            ([40, 64, 96], [0, 3, 5], [1, 2, 6], [5.0, 5.4, 4.8],
             [0.3, 0.25, 0.35], 2),
            ([96], [4], [3], [5.2], [0.3], 3),
            ([30], [1], [5], [4.9], [0.4], 4)]
    requests, expect, calls = [], [], []
    dur_fn, _ = make_two_stage_fns(model_gpu)
    buckets = sorted(TEXT_BUCKETS, key=lambda bt: bt[0] * bt[1])
    for n_tok, spk, acc, f0m, f0s, req_seed in plan:
        ids = [rng.integers(1, 426, n).tolist() for n in n_tok]
        text = np.zeros((len(ids), max(n_tok)), np.int32)
        for i, s in enumerate(ids):
            text[i, :len(s)] = s
        per_item = [np.asarray(n_tok, np.int32), np.asarray(spk, np.int32),
                    np.asarray(acc, np.int32), np.asarray(f0m, np.float32),
                    np.asarray(f0s, np.float32)]
        # frames each item should get, from stage A of the same weights on
        # the same padded batch (run before the launch count starts)
        _, b, text_p, padded = _pad_request(buckets, text, per_item)
        _, _, n_frames = dur_fn(text_p, *padded[:3])
        expect.append(np.minimum(n_frames[:b].cpu().numpy(),
                                 FRAME_BUCKETS[-1]))
        calls.append((text, *per_item, req_seed))
        requests.append({"text_ids": ids, "speaker_id": spk,
                         "accent_id": acc, "f0_mean": f0m, "f0_std": f0s,
                         "seed": req_seed, "format": "wav"})

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/tts.pt"
        t0 = time.perf_counter()
        n_bytes = export_tts(model, path, vocoder=vocoder,
                             buckets=TEXT_BUCKETS, frame_buckets=FRAME_BUCKETS)
        log(f"[serve] artifact {n_bytes / 2**20:.1f} MiB written in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        httpd = serve(path, host="127.0.0.1", port=0, device="cuda")
        log(f"[serve] artifact loaded on the card in "
            f"{time.perf_counter() - t0:.2f} s")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        for k, req in enumerate(requests):   # cold: first use of each shape
            t0 = time.perf_counter()
            status, _ = _post(httpd.server_address, req)
            log(f"[serve] cold request {k}: HTTP {status}, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        # the main path: counts from zero, four requests, counts read after
        lstm_kernel.launches = 0
        for k, req in enumerate(requests):
            ids = req["text_ids"]
            n_items = len(ids)
            t0 = time.perf_counter()
            status, blob = _post(httpd.server_address, req)
            ms = (time.perf_counter() - t0) * 1e3
            if status != 200:
                fail(f"request {k}: HTTP {status}: {blob[:300]!r}")
            wavs = _wavs(blob, n_items)
            if len(wavs) != n_items:
                fail(f"request {k}: {len(wavs)} WAVs for {n_items} texts")
            for i, w in enumerate(wavs):
                with wave.open(io.BytesIO(w)) as wf:
                    if (wf.getsampwidth(), wf.getframerate(),
                            wf.getnchannels()) != (2, SR, 1):
                        fail(f"request {k} item {i}: not 16-bit mono {SR} Hz")
                    pcm = np.frombuffer(wf.readframes(wf.getnframes()),
                                        "<i2")
                want = int(expect[k][i]) * HOP
                if pcm.size != want:
                    fail(f"request {k} item {i}: {pcm.size} samples, "
                         f"expected {want}")
                if pcm.size == 0 or not np.abs(pcm).max() > 0:
                    fail(f"request {k} item {i}: empty or silent audio")
            log(f"[serve] request {k}: {n_items} text(s), "
                f"{[len(s) for s in ids]} "
                f"tokens, frames {expect[k].tolist()}, {ms:.1f} ms")
        launches = lstm_kernel.launches
        # where the device time of one warm 96-token request goes, through
        # the callable the daemon dispatches to
        profile_call(httpd.service.tts, calls[2])
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    want = 4 * len(requests)   # encoder + duration DAP + frame DAPs + context
    log(f"[serve] lstm_recurrence launches on the main path: {launches} "
        f"(expected {want})")
    if launches < want:
        fail("the serving path did not go through the LSTM kernel")
    return launches


def profile_call(tts, args, top: int = 12):
    """torch.profiler over one call: device time by kernel (kernels only,
    not the operators that launch them, so nothing counts twice), and
    device busy time against the wall time of the traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    tts(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tts(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels (and copies) only: an operator's device time is its kernels'
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms == 0:
        log("[profile] the profiler saw no device time: not measured")
        return
    log(f"[profile] one request ({args[0].shape[1]} tokens, traced): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {sum(r[2] for r in rows)} "
        "kernels")
    for key, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"[profile]   {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% "
            f"x{n:<5d} {key[:90]}")


@tf32_off()
def phase_parity(seed: int, model, model_gpu):
    """Stage A on the card and on the CPU, compared on its float outputs
    (encoder states, durations before rounding); then stage B on both
    from the CPU's stage A, so both decode the same integer durations.
    Rounding a duration is discontinuous: a value near k + 0.5 may round
    apart on the two devices and shift every later frame."""
    from radmmm_torch.serving import TwoStageTTS
    from radmmm_torch.utils.masking import SeqLens
    rng = np.random.default_rng(seed + 1)
    args = (rng.integers(1, 426, (1, 12)).astype(np.int32),
            np.asarray([12], np.int32), np.asarray([2], np.int32),
            np.asarray([3], np.int32), np.asarray([5.1], np.float32),
            np.asarray([0.3], np.float32))
    models = {"cuda": model_gpu, "cpu": model}
    stage_a, pre = {}, {}
    for where, m in models.items():
        text, lens, spk, acc = [torch.as_tensor(a, device=where)
                                for a in args[:4]]
        with torch.inference_mode():
            stage_a[where] = [x.cpu() for x in TwoStageTTS(
                m, frame_buckets=FRAME_BUCKETS, sigma=0.0).dur(*args[:4])]
            in_lens = SeqLens.create(lens, text.shape[1])
            acc_vecs = m.accent_embeddings(acc)
            txt_enc, _ = m.encode_text(text, in_lens, acc_vecs)
            pre[where] = m.duration_predictor.infer(
                txt_enc, m.speaker_embeddings(spk), in_lens,
                accent_emb=acc_vecs)[..., 0].cpu()
    enc_err = (stage_a["cuda"][0] - stage_a["cpu"][0]).abs().max().item()
    pre_err = (pre["cuda"] - pre["cpu"]).abs().max().item()
    flips = (stage_a["cuda"][1] != stage_a["cpu"][1]).nonzero().tolist()
    log(f"[parity] stage A: txt_enc max_abs_err {enc_err:.3e}, durations "
        f"before rounding max_abs_err {pre_err:.3e} (atol {PARITY_ATOL:g}); "
        f"integer durations {stage_a['cpu'][1].tolist()}, rounded apart at "
        f"{flips or 'no token'}")
    if not (enc_err <= PARITY_ATOL and pre_err <= PARITY_ATOL):
        fail("card and CPU disagree in stage A")
    txt_enc, durations, n_frames = stage_a["cpu"]
    mels = {}
    for where, m in models.items():
        tts = TwoStageTTS(m, frame_buckets=FRAME_BUCKETS, sigma=0.0)
        frames = tts.pick_bucket(n_frames)
        t0 = time.perf_counter()
        mel, lens = tts.decode[frames](txt_enc.to(where), durations.to(where),
                                       *args[2:], 0)
        mels[where] = mel.cpu().numpy()
        log(f"[parity] stage B {where}: mel {tuple(mel.shape)}, lens "
            f"{lens.tolist()}, {time.perf_counter() - t0:.2f} s")
    mg, mc = mels["cuda"], mels["cpu"]
    err = float(np.abs(mg - mc).max())
    log(f"[parity] card vs CPU mel max_abs_err {err:.3e} (atol "
        f"{PARITY_ATOL:g}: f32 on both, TF32 off, sums in another order "
        f"through 8 flow inverses; mel max {float(np.abs(mc).max()):.2f})")
    if not (np.isfinite(mg).all() and err <= PARITY_ATOL):
        fail("card and CPU mels disagree")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 2
    # outside a checkout of the repository this import fails
    from radmmm_torch.ops import lstm_kernel  # noqa: F401

    t_start = time.perf_counter()
    rows, launches = [], None
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        rows = phase_kernels(args.seed)
    if "serve" in phases or "parity" in phases:
        t0 = time.perf_counter()
        model, vocoder = build_models(args.seed)
        model.cache_inverses()
        model_gpu = copy.deepcopy(model).cuda().cache_inverses()
        log(f"[models] full-width models built in "
            f"{time.perf_counter() - t0:.2f} s")
        if "serve" in phases:
            launches = phase_serve(args.seed, model, vocoder, model_gpu)
        if "parity" in phases:
            phase_parity(args.seed, model, model_gpu)
    if rows:
        b1 = [r for r in rows if r["B"] == 1]
        entry = {
            "name": "lstm_recurrence", "route": "cuda",
            "source": "radmmm_torch/csrc/lstm_recurrence.cu",
            "replaces": "radmmm_tpu/ops/lstm_pallas.py:35",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            # one B=1 request at text bucket 96 / frame bucket 800 makes
            # one launch at each path shape: its numbers are their sums
            "ms": sum(r["ms"] for r in b1),
            "plain_ms": sum(r["plain_ms"] for r in b1),
            "bound_ms": sum(r["bound_ms"] for r in b1),
            "bound_by": max(b1, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in b1),
            "shapes": rows,
        }
        log(json.dumps({"kernels": [entry]}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
