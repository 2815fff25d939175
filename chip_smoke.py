#!/usr/bin/env python3
"""Smoke run of the radmmm_torch serving and training paths on one CUDA card.

    python3 chip_smoke.py [--phases build,kernels,serve,parity,train,
                           train_parity,wn,featurize,vocoder,fit,
                           radtts_fit,m12,ddp,caches,bf16,graphs,
                           graphs_nccl]
                          [--seed 0]

Phases (all by default):

1. build    compile every kernel source under radmmm_torch/csrc/ for sm_90a
            into build/ (one nvcc each, all at once) and print the build
            time, ptxas's register counts and the card's name and power
            limit;
2. kernels  each kernel against its plain PyTorch twin, TF32 off, with
            the times of kernel, twin, a PyTorch library call computing the
            same function (where there is one) and the card's lower bound
            for the same work:
            - K4 forward, the LSTM recurrence, at the serving path's four
              shapes (TextEncoder BiLSTM H=260, duration DAP H=128, six
              ganged frame-DAP lanes H=128, flow context BiLSTM H=528 with
              input 1060), B=1 and B=8, and at the training step's four
              shapes (B=8, T_text 96, T_mel 512) with its saved states,
              each with the route its plan took (a cluster per lane, or
              the cooperative grid) and its us per step; library: cuDNN
              nn.LSTM over packed sequences;
            - K4 backward at the training shapes, with the route its plan
              took (a cluster per lane, or the cooperative grid) and its
              us per step; library: the backward of cuDNN nn.LSTM over
              packed sequences;
            - K1 and K2, the CTC alpha and beta DPs, at B=8, T_mel=512,
              2*96+1 states; library: F.ctc_loss forward and its backward
              on the equivalent targets 1..96 with the blank column; K2
              also with its wavefront plan (warps x states a lane), us a
              row, and a ragged batch whose longest item has half the
              frames;
            - K3, width-1 MAS, at (8, 512, 96), bit for bit; no PyTorch
              call computes MAS, so no library time; its plan and us a
              row;
            - K5, the fused dilated conv + softplus of the WN stack, at the
              bench script's shape (B 32, T 256, C 1024, K 5) for each
              dilation 1, 2, 4, 8, and at a ragged one (B 3, T 250);
              library: F.conv1d in bf16 through cuDNN plus softplus,
              timed with cudnn.benchmark on (and its default algorithm
              logged beside); gemm_ms: a bf16 torch.matmul of the same
              (B T, K Cin) x (K Cin, Cout) size;
            - K6, pYIN's Viterbi, at (8, 513, 2, 181) on random tables, bit
              for bit against its twin; no PyTorch call computes a Viterbi
              path, so no library time; its bound the chain of dependent
              frames (or its bytes and operations, whichever is longer),
              its cluster and us a frame;
            - K7, the WN stacks' f32 convolutions, forward, dgrad and
              wgrad at the flagship's WN shapes (B 8, T/2 256: in_i at
              dilations 1 and 8, res_skip, start at 1,136 and 1,135
              inputs, end at 160 and 158 outputs) and at
              radtts.train.f0cache's largest batch (T/2 448), forward at
              serving's four B = 1 buckets: its error against the twin,
              two runs bit for bit, kernel and library (cuDNN's f32
              convolution with cudnn.benchmark on) timed as CUDA graphs;
3. serve    the full-width RADMMM model and HiFi-GAN v1 (22,050 Hz) with
            random weights from --seed, exported as a serving artifact,
            served over HTTP by radmmm_torch.server on 127.0.0.1; four
            requests (batch 1 and 3, 12 to 96 tokens, WAV output) are
            checked and the kernel's launches on them counted;
4. parity   one 12-token request through stage A+B at sigma=0, mel only,
            on the card and on the CPU: stage A compared on its float
            outputs, stage B on the same integer durations;
5. train    the full-width model from --seed and the benchmark's batch
            (B=8, T_text=96, T_mel=512, full lengths): the whitening init,
            one warm-up step, then TRAIN_STEPS (3) steps of
            make_train_step(binarize=True, kl_on=True) with RAdam, in full
            f32 (TF32 off); every loss term and the grad norm finite, the
            launches per step exactly K1 1, K2 1, K3 1, K4 forward 4, K4
            backward 4, K6 0; ms/step, mel frames/s and a profile of one step;
6. train_parity  one step at full width and short lengths (B=2, T_text 12,
            T_mel 64, dropout off) on the card and on the CPU from the same
            weights and batch, TF32 off: loss terms, grad norm and every
            parameter's gradient compared;
7. wn       the bench entry point radmmm_torch.scripts.bench_wn_kernel at
            B 32, T 256: exactly 4 K5 launches per fused stack call, the
            fused stack against variant A (cuDNN bf16) within bf16
            rounding, and its table of the three variants;
8. featurize  TF32 off: eight synthetic voiced utterances (harmonic tones
            with vibrato, an unvoiced gap, silence; 131,071 samples, so 512
            mel frames; 96 text tokens), collated and quantised to int16,
            featurized on the card and on the CPU and compared key by key;
            then TRAIN_STEPS flagship training steps from that batch with
            the launch counts of the train phase, featurize and step times,
            and one reconstruct at sigma 0 on the card;
9. vocoder  TF32 off: ``vocoder-fit`` through radmmm_torch.training.cli.main
            in this process, on a synthetic 16 kHz corpus of 32 lines of
            each of the fit phase's two filelists (batches of 16, the
            recipe's data section and featurizer): HiFi-GAN v1 at full
            width (512 channels, rates 8, 8, 2, 2; MPD periods 2-11; 3-scale
            MSD; segments of 8,192; AdamW 2e-4) fit to 6 steps, then
            resumed to 8 with steps 7-8 profiled (ms a step, the card's busy
            share and top kernels, peak memory, checkpoint save and restore
            seconds and bytes, the resume's step count and rows); WaveGlow()
            (12 flows of WN 256 x 8) for 4 steps. Then vocoding of 4 mels
            of 390 frames with the Denoiser, timed, and held against the
            CPU: the trained HiFi-GAN from its run directory, an iSTFTNet
            C8C8I generator and an upstream-format WaveGlow file at sigma
            0, both from random weights of --seed; and cuFFT's inverse real
            FFT against the CPU's on spectra with imaginary DC and Nyquist
            parts. No kernel of K1-K6 runs on this path: its launches are
            counted from zero and must stay 0;
10. fit     the shipped 7-language recipe (configs/radmmm_model.yaml,
            radmmm_attributes.yaml, radmmm_opensource_data_phonemizerless
            .yaml, radmmm_train.yaml) at full width through
            radmmm_torch.training.cli.main in this process, on a synthetic
            corpus in a temporary directory: 12 training and 4 validation
            lines of at most 6 s from each of two shipped phonemized
            filelists (LJSpeech en_US, M-AILABS tux es_ES), their text,
            speaker and emotion kept, with 16 kHz int16 voiced audio of
            their durations; an overlay that swaps the corpora, sets 6
            steps, validation and checkpoints every 3, the binarization
            switch at 3 and KL at 4, and the vocoder phase's HiFi-GAN run
            as the vocoder. fit to 6 steps (HiFi-GAN validation audio with
            the Denoiser, Griffin-Lim without the vocoder phase;
            checkpoints 3 and 6, two steps profiled),
            fit again to 8 (it resumes from 6 and keys its noise from 6),
            predict on the recipe's prompts of the corpus's speakers,
            export with an upstream-format HiFi-GAN v1 g_* file of random
            weights baked in and one request through serving.load_tts
            (int16 audio on the card). Checks:
            every logged loss finite, each training step's launches (K1
            1, K2 1, K4 forward 4, K4 backward 4, K3 1 once binarization
            is on), the resume, the wavs' lengths; prints ms a step, the
            loader's share, the device's busy share and top kernels of
            the profiled steps, peak device memory, featurize ms,
            validation, checkpoint, predict and export times;
11. radtts_fit  tracked stack (2), the LJSpeech RADTTS decoder with its four
            attribute predictors (configs/radtts_model.yaml, the four
            radtts_*model.yaml, ljs_22khz_data.yaml, radmmm_train.yaml), at
            full width through the same CLI and the same overlay and checks
            as fit, on a synthetic 22,050 Hz corpus in place of LJS: 24
            training and 4 validation lines of at most 6 s of the shipped
            phonemized LJSpeech filelists (the stack's G2P dictionary is not
            in the repository: the build says G2P is disabled, and an empty
            one lets the recipe's braced prompts through), Griffin-Lim in
            validation, a 22,050 Hz HiFi-GAN v1 g_* file baked into the
            export. Its LSTMConvDAP duration predictor's BiLSTM (H 128) is
            one of the four K4 launches of each step, forward and backward;
            every step also logs a finite duration loss;
12. m12     TF32 off, the card against the CPU from the same weights and
            inputs: (a) configs/radtts_model.yaml's decoder with n_splines 2
            at full width (80 mels, n_group_size 2, 8 flows, WN 1024, FiLM
            512) on B=8, T_mel 512: the flow loss, every gradient (the
            spline couplings' by Frobenius norm) and the
            batch norms' running statistics after one training forward and
            backward, then infer at sigma 0 on them; (b) AffineCoupling with
            simple_conv and with film_stack at the flow's widths: forward and
            inverse, and the card's round trip; (c) DeterministicDecoder,
            DiffusionDecoder and E2ETTSDecoder (HiFi-GAN v1) at their default
            widths on B=4, T_text 64, T_mel 256, their attention terms from
            ConvAttention on the batch (K3, K1 and K2), one loss step each
            on the card (backward and Adam) with the loss terms held against
            the CPU, and the diffusion decoder's 100-step ancestral sampling
            with its draws fed. Each part prints its ms and its error
            beside its bound, and its kernels' launches are checked;
13. ddp     training on two ranks (radmmm_torch.parallel): NCCL with a
            card a rank when there are two cards or more, else both ranks
            on card 0 over gloo with CUDA tensors (then also a one-rank
            NCCL group on card 0 runs NCCL's all-gather, reduce-scatter
            and all-reduce once, and the references run in it), chosen by
            the count of cards. Each rank is a child process of this one
            (chip_smoke.py --ddp-child) under a timeout. TF32 off, dropout
            off, the flagship model at full width from --seed. (a) data
            parallel: two ranks of B 8 (T_text 96, T_mel 512, ragged
            lengths, so they hold other numbers of valid frames) against
            one rank on their B 16: the whitening init's mean and
            covariance, every loss term and the grad norm, every
            gradient (the train_parity bound), then 3 timed steps with
            each rank's ms a step, its gradient all-reduce (ms, bytes),
            peak memory and launches (K4 4 + 4, K1 1, K2 1, K3 1 a step),
            and the ranks' parameter checksums equal after; gloo's answer
            to each collective on CUDA tensors is printed. (b) tensor
            parallel: n_model 2, both ranks B 8, the WN stacks split
            (assert_tp_layout on each rank), against one rank on B 8,
            the same checks, the replicated parameters equal; with NCCL
            and four cards or more, also n_data 2 x n_model 2 on four
            ranks against one rank on B 16. (c) fit
            --distributed of the 7-language recipe at full width through
            python -m torch.distributed.run --standalone --nproc-per-node 2
            on a synthetic 16 kHz corpus of 16 copies of one line of each
            of the fit phase's two filelists: fit to 3 steps (validation
            at 3), then a resume to 5: one checkpoint after the fit, one
            writer of metrics.jsonl, each step logged once and finite,
            the launches of each training step (graphed over NCCL, eager
            over gloo, which cannot be captured), the ranks' parameters
            alike bit for bit after each run. (d) the E2E-GAN decoder's
            STFT loss (RADTTSE2EGANLoss, five resolutions) on two data
            ranks of 2 items of up to 2 s of audio, the longest on rank 1
            only (chip_smoke.py --e2e-child), against one rank on the 4:
            the ranks' loss terms sum to its, their audio_hat gradients
            are its rows;
14. caches  TF32 off: the feature caches (radmmm_torch/native.py,
            data/f0_cache.py) on a synthetic 22,050 Hz corpus like
            radtts_fit's (24 training and 4 validation lines): the audio
            cache and the F0 cache (pYIN on the card) built through
            radmmm_torch.scripts.build_audio_cache and build_f0_cache, with
            their records and seconds; eight items' batch from the caches
            against the wavs' with pYIN, featurized on the card (mel and
            energy within 1e-6, F0 within 5e-3 on more than 90% of each
            item's valid frames, voicing equal on more than 90%, padding
            zero) and the featurize ms of each; native.mas_batch_cpu against
            K3 bit for bit at (8, 512, 96), full and ragged; then stack
            (2)'s fit to 6 steps without the caches and with them (steps
            5-6 profiled): every batch with its tracks (pYIN skipped) or
            without, each step's launches (K4 4 + 4, K1 1, K2 1, K3 1 once
            binarized), ms a step, the loader's share and the card's busy
            share of each;
15. bf16    model.conv_precision bf16 (the process-wide switch of
            radmmm_torch/ops/conv.py), TF32 off but for the requests:
            K4's bf16 variant at the serving shapes (B 1 and 8) and the
            training shapes, its backward's at the training shapes, each
            against its bf16 twin with its route, us a step, the twin's
            ms, cuDNN's nn.LSTM in bf16, the bound and the f32 kernel's ms
            at the same shape (csrc/lstm_recurrence_bf16.cu: the products
            on the tensor cores), and their sums over the step's and a
            request's four shapes against the f32 kernels'; the flow
            context's lane on both routes, the plan's and the other, in
            turns; the LSTM input projections in bf16; the
            flagship step in bf16 (3 warm steps, launches K4-bf16 4 + 4,
            K1 1, K2 1, K3 1 and no f32 K4, peak memory, one profiled step,
            beside the train phase's f32 ms), its loss terms against f32's
            from the same weights and batch, and the short step of
            train_parity card against CPU in bf16 (loss terms, gradients
            by Frobenius norm); the recipe's fit for 4 steps and predict
            through the CLI with model.conv_precision bf16; the serve
            phase's four HTTP requests in bf16, with its TF32 settings;
16. graphs  the JAX package's compiled programs as CUDA graphs
            (radmmm_torch/utils/graphs.py: a signature's first call warms
            up eagerly, its second captures and replays), TF32 off: (a) in
            f32 and in bf16, the flagship featurize + step from int16
            audio (the featurize phase's eight utterances, each step's
            audio rolled, mel noise 0.01; B 8, T_text 96, T_mel 512;
            binarize and KL on) through training/step.make_train_megastep,
            2 x 8 steps graphed against 2 x 8 eager featurize_raw +
            make_train_step steps from the same weights, batches and
            dropout generator, twice, under cuDNN's deterministic
            algorithms: every metric, every parameter and the generator
            bit for bit, two warm-ups and two captures (RAdam's two
            branches) and 14 replays, their shared pool at most 64 MiB
            larger than the larger graph (the rectified branch) captured
            alone into a pool of its own, the launch ledger's counts (K4
            4 + 4, K1 1, K2 1, K3 1, K6 1 a step: each step featurizes
            with pYIN inside its graph); then at cuDNN's defaults, a
            new capture and ms a step graphed against eager over 8 steps
            each, one step of each profiled (busy, kernels, the host's
            launch calls), capture seconds, the pool's bytes, peak memory;
            (b) a serving artifact at the (1, 96) and (4, 96) buckets and
            the four frame buckets loaded with serving.load_tts (every
            bucket warmed up and captured at load: seconds and bytes of
            each), 20 requests a bucket graphed against the eager request
            path in turns with the same seeds, int16 PCM equal, p50 and
            p99 each way, K4 4 launches a graphed request; in bf16 one
            request a bucket; (e) the recipe's fit through the CLI for 24
            steps on a corpus of one line a source copied 64 times,
            megastep_k 4 (whole groups), graphed against the trainer's
            eager steps (a Trainer whose step factory takes no graph
            pool): each step's launches, warm-ups, captures and replays,
            the logged losses, ms a step over two whole groups; (f) the
            recipe's fit for 24 steps, megastep_k 4, on the fit phase's
            corpus at 32 lines a source (six batch shapes, most groups
            partial, the binarization and KL switches inside groups),
            validation every 8 steps (the losses), one loader thread,
            graphed against eager under cuDNN's deterministic algorithms:
            the logged losses and validations bit for bit, each step's and
            each validation's launches alike, the steps that replay
            exactly those whose (shape, phase, RAdam branch) was seen
            before, ms a step over them and validation seconds each way;
            then the same with megastep_k 1 (the loader featurizes each
            batch in its thread and the step alone is graphed, over the
            batch's natural bucket shapes); (c) the port's
            aug_disentangle_experiment script at 16 steps a fit;
17. graphs_nccl
            (g) with two cards or more, fit --distributed over NCCL
            (n_data 2, torchrun, the ddp phase's corpus) for 16 steps in
            groups of 4 with validation every 6, graphed against eager:
            rank 0's loss terms within the ddp phase's bounds, its
            collectives and launches alike, ms a step and a traced step's
            wall, busy time and host launch calls each way; with one card
            a line says (g) did not run and nothing is reported as passed.

Any failure exits non-zero. The line before the last is a JSON object
with the kernels' numbers; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import http.client
import io
import json
import math
import shutil
import struct
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

PHASES = ("build", "kernels", "serve", "parity", "train", "train_parity",
          "wn", "featurize", "vocoder", "fit", "radtts_fit", "m12", "ddp",
          "caches", "bf16", "graphs", "graphs_nccl")
# (name, lanes, hidden, time steps, LSTM input width) on the serving path
# at text bucket 96 and frame bucket 800 (the flow context runs at 800/2)
PATH_SHAPES = (("text_encoder", 2, 260, 96, 520),
               ("duration_dap", 2, 128, 96, 256),
               ("frame_daps_ganged", 6, 128, 800, 256),
               ("flow_context", 2, 528, 400, 1060))
# the same four recurrences in the training step at T_text 96, T_mel 512
TRAIN_SHAPES = (("text_encoder", 2, 260, 96, 520),
                ("duration_dap", 2, 128, 96, 256),
                ("frame_daps_ganged", 6, 128, 512, 256),
                ("flow_context", 2, 528, 256, 1060))
TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL = 8, 96, 512
TRAIN_STEPS = 3
KERNEL_ATOL = 1e-5
# the backward's dgates and the CTC band values grow with depth: held to
# 1e-5 relative to their magnitude, with a 1e-5 floor
KERNEL_RTOL = 1e-5
# the bf16 variants of K4 against their bf16 twins: the same bf16-rounded
# operands and f32 sums in another order, so an h (or dgates) value each
# side rounds may land on either side of a bf16 rounding boundary and move
# by 2^-8 of itself: absolute in the forward, relative with that floor in
# the backward
BF16_KERNEL_ATOL = 1e-3
PARITY_ATOL = 1e-3
TRAIN_PARITY_RTOL = 1e-3
# each parameter's gradient, card against CPU, over its leaf's largest
# (at least GRAD_FLOOR of the tree's). Read on an H100: 1.8e-6 at worst
# in the leaves the flow loss does not reach, up to 1.7e-3 in those it
# does, since the whitening 1x1 fitted to this short batch (57 frames for
# 160 channels, held invertible by a 1e-5 ridge) scales rounding in its
# null directions by about 300
GRAD_PARITY_RTOL = 5e-3
GRAD_FLOOR = 1e-6
PEAK_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_FLOP_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_BF16_FLOP_PER_S = 989e12   # H100 SXM, bf16 dense tensor cores
# K5 against its twin: the same bf16 products, 5,120 of them per output,
# summed in f32 in another order
K5_ATOL = 1e-4
WN_B, WN_T = 32, 256
# the fused stack against variant A, which rounds each conv output to bf16
# (2^-9 relative) before the softplus: 2^-6 of the largest magnitude
# covers four layers
WN_PARITY_RTOL = 2.0 ** -6
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


def graph_ms(fn, reps: int) -> float:
    """Device ms of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after two eager warm-up calls on the capture's stream, which
    take any autotuning), the graph replayed twice between events. The
    host's launch time, which a graphed step does not pay, stays out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (2 * reps)


def phase_build():
    from radmmm_torch.utils import cuda_build
    from radmmm_torch.utils.device import card_line
    t0 = time.perf_counter()
    libs = cuda_build.build(force=True)
    log(f"[build] {len(libs)} kernel libraries built in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel)")
    for name in libs:
        ptxas = cuda_build.BUILD_DIR / f"{name}.ptxas.txt"
        for line in ptxas.read_text().splitlines():
            if any(k in line for k in ("registers", "smem", "spill",
                                       "arning")):
                log(f"[build] {name} ptxas: {line.strip()}")
    log(card_line())


def _lengths(T: int, B: int) -> torch.Tensor:
    if B == 1:
        return torch.tensor([T * 7 // 8])
    return torch.tensor([T - i * T // (B + 1) for i in range(B)])


def _bound(n_bytes: float, flops: float,
           peak_flops: float = PEAK_F32_FLOP_PER_S) -> tuple:
    """(least ms, what bounds it): the bytes at the HBM rate or the
    operations at the peak rate of their type (f32 unless given),
    whichever takes longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(L, T, B, H, valid_frames, save=False, bf16=False) -> tuple:
    """Least time for the recurrence: each input read once, the output
    (and in training the saved gates, c and h) written once; 8H² FLOP per
    (lane, valid frame) for h @ Wh, at the bf16 peak for the bf16 variant
    (its operands are bf16; every input and output stays f32)."""
    n_out = L * T * B * H * (7 if save else 1)
    n_bytes = 4 * (L * T * B * 4 * H + T * B + L * H * 4 * H + n_out)
    return _bound(n_bytes, 8.0 * H * H * L * valid_frames,
                  PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S)


def bound_bwd_ms(L, T, B, H, valid_frames, bf16=False) -> tuple:
    """The backward reads dout, the saved gates and c, the mask and Wh and
    writes dgates; 8H² FLOP per (lane, valid frame) for dgates @ Wh^T (at
    the bf16 peak for the bf16 variant)."""
    n_bytes = 4 * (L * T * B * H * 2 + L * T * B * 4 * H * 2 + T * B
                   + L * H * 4 * H)
    return _bound(n_bytes, 8.0 * H * H * L * valid_frames,
                  PEAK_BF16_FLOP_PER_S if bf16 else PEAK_F32_FLOP_PER_S)


def _rel_err_ok(got, want, rtol=KERNEL_RTOL, floor=1e-5) -> tuple:
    """(max abs error, within ``rtol`` of the magnitude with a ``floor``)."""
    diff = (got - want).abs()
    ok = bool((diff <= floor + rtol * want.abs()).all())
    return diff.max().item(), ok


def _cudnn_lstms(L, H, cin, dev, dtype=torch.float32):
    return [torch.nn.LSTM(cin, H, bidirectional=True).to(dev, dtype)
            for _ in range(L // 2)]


def _lstm_rows(gen, dev, name, L, H, T, cin, B, train: bool,
               bf16: bool = False):
    """K4 forward (and in training K4 backward) at one shape: error
    against the twin, times of kernel, twin and cuDNN, the bound. With
    ``bf16`` the kernels' bf16 variants against the bf16 twins (within
    BF16_KERNEL_ATOL), cuDNN's LSTM in bf16, and the f32 kernel's time at
    the same shape beside them."""
    from radmmm_torch.ops.lstm_kernel import (
        _backward_kernel, _forward_kernel, card_backward_plan,
        card_forward_plan, lstm_recurrence,
        lstm_recurrence_backward_reference, lstm_recurrence_reference)
    twin = functools.partial(lstm_recurrence_reference, bf16=bf16)
    twin_bwd = functools.partial(lstm_recurrence_backward_reference,
                                 bf16=bf16)
    fwd_k = functools.partial(_forward_kernel, bf16=bf16)
    bwd_k = functools.partial(_backward_kernel, bf16=bf16)
    atol = BF16_KERNEL_ATOL if bf16 else KERNEL_ATOL
    suffix = "_bf16" if bf16 else ""
    ldt = torch.bfloat16 if bf16 else torch.float32
    lens = _lengths(T, B)
    mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
    xp = torch.randn((L, T, B, 4 * H), generator=gen, device=dev)
    wh = (torch.rand((L, H, 4 * H), generator=gen, device=dev)
          * 2 - 1) / H ** 0.5
    rev = [bool(l % 2) for l in range(L)]
    valid = int(lens.sum())
    # cuDNN yardstick: L/2 bidirectional nn.LSTM calls over packed
    # sequences of the layer's real input (its x @ W_ih included)
    lstms = _cudnn_lstms(L, H, cin, dev, ldt)
    x = torch.randn((T, B, cin), generator=gen, device=dev, dtype=ldt,
                    requires_grad=train)
    packed = torch.nn.utils.rnn.pack_padded_sequence(x, lens,
                                                     enforce_sorted=False)
    tag = "train" if train else "serve"
    if not train:
        got = lstm_recurrence(xp, mask, wh, rev, bf16=bf16)
        want = twin(xp, mask, wh, rev)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ok = err <= atol
        k_ms = cuda_ms(lambda: lstm_recurrence(xp, mask, wh, rev, bf16=bf16),
                       20)
        p_ms = cuda_ms(lambda: twin(xp, mask, wh, rev), 2)
        f32_ms = cuda_ms(lambda: lstm_recurrence(
            xp, mask, wh, rev, bf16=False), 20) if bf16 else None
    else:
        got = fwd_k(xp, mask, wh, rev, save=True)
        want = twin(xp, mask, wh, rev, save=True)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        ok = err <= atol
        k_ms = cuda_ms(lambda: fwd_k(xp, mask, wh, rev, True), 20)
        p_ms = cuda_ms(lambda: twin(xp, mask, wh, rev, save=True), 2)
        f32_ms = cuda_ms(lambda: _forward_kernel(
            xp, mask, wh, rev, True), 20) if bf16 else None

    def library():
        for m in lstms:
            m(packed)
    with torch.no_grad():
        lib_ms = cuda_ms(library, 10)
    b_ms, b_by = bound_ms(L, T, B, H, valid, save=train, bf16=bf16)
    fplan = card_forward_plan(L, B, H, bf16)
    fwd = dict(kernel="lstm_recurrence" + suffix, path=tag, shape=name, L=L,
               H=H, T=T, B=B, max_abs_err=err, ms=k_ms, plain_ms=p_ms,
               library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               us_per_step=k_ms * 1e3 / T, route=fplan.route,
               ctas_per_lane=fplan.n_cta, hb=fplan.hb)
    if bf16:
        fwd["f32_ms"] = f32_ms
    phase = "bf16" if bf16 else "kernels"
    log(f"[{phase}] K4{suffix} {tag} {name} L={L} H={H} T={T} B={B}: "
        f"max_abs_err {err:.3e} (atol {atol:g}"
        f"{', saved states included' if train else ''}), kernel_ms "
        f"{k_ms:.4f} ({k_ms * 1e3 / T:.2f} us/step, route {fplan.route}: "
        f"{fplan.n_cta} CTAs a lane of {fplan.hb} units, ks {fplan.ks}), "
        f"plain_ms {p_ms:.3f}, library_ms {lib_ms:.4f}"
        f"{' (cuDNN in bf16)' if bf16 else ''}, bound_ms {b_ms:.5f} "
        f"({b_by})" + (f", f32 kernel_ms {f32_ms:.4f}" if bf16 else ""))
    if not ok:
        fail(f"K4{suffix} forward disagrees with its twin at {tag} {name} "
             f"B={B}")
    if not train:
        return fwd, None

    _, act, cs, _ = got
    dout = torch.randn((L, T, B, H), generator=gen, device=dev)
    g = bwd_k(dout, act, cs, mask, wh, rev)
    w = twin_bwd(dout, act, cs, mask, wh, rev)
    torch.cuda.synchronize()
    err_b, ok_b = (_rel_err_ok(g, w, BF16_KERNEL_ATOL, BF16_KERNEL_ATOL)
                   if bf16 else _rel_err_ok(g, w))
    kb_ms = cuda_ms(lambda: bwd_k(dout, act, cs, mask, wh, rev), 20)
    pb_ms = cuda_ms(lambda: twin_bwd(dout, act, cs, mask, wh, rev), 2)
    fb_ms = cuda_ms(lambda: _backward_kernel(
        dout, act, cs, mask, wh, rev), 20) if bf16 else None
    outs = [m(packed)[0].data for m in lstms]
    grads = [torch.randn_like(o) for o in outs]
    inputs = [x] + [p for m in lstms for p in m.parameters()]
    libb_ms = cuda_ms(lambda: torch.autograd.grad(
        outs, inputs, grads, retain_graph=True), 10)
    bb_ms, bb_by = bound_bwd_ms(L, T, B, H, valid, bf16)
    plan = card_backward_plan(L, B, H, bf16)
    bwd = dict(kernel="lstm_recurrence_bwd" + suffix, path=tag, shape=name,
               L=L, H=H, T=T, B=B, max_abs_err=err_b, ms=kb_ms,
               plain_ms=pb_ms, library_ms=libb_ms, bound_ms=bb_ms,
               bound_by=bb_by, us_per_step=kb_ms * 1e3 / T,
               route=plan.route, ctas_per_lane=plan.n_cta, hb=plan.hb)
    if bf16:
        bwd["f32_ms"] = fb_ms
    tol = (f"rtol {BF16_KERNEL_ATOL:g}, floor {BF16_KERNEL_ATOL:g}" if bf16
           else f"rtol {KERNEL_RTOL:g}, floor 1e-5")
    log(f"[{phase}] K4{suffix}-backward {name} L={L} H={H} T={T} B={B}: "
        f"max_abs_err {err_b:.3e} ({tol}, of "
        f"|dgates| up to {w.abs().max().item():.2f}), kernel_ms "
        f"{kb_ms:.4f} ({kb_ms * 1e3 / T:.2f} us/step, route {plan.route}: "
        f"{plan.n_cta} CTAs a lane of {plan.hb} units, ks {plan.ks}), "
        f"plain_ms {pb_ms:.3f}, library_ms {libb_ms:.4f}, "
        f"bound_ms {bb_ms:.5f} ({bb_by})"
        + (f", f32 kernel_ms {fb_ms:.4f}" if bf16 else ""))
    if not ok_b:
        fail(f"K4{suffix} backward disagrees with its twin at {name}")
    return fwd, bwd


def _ctc_inputs(gen, dev, ragged: bool):
    from radmmm_torch.losses.ctc import _ctc_setup
    B, Tm, Tt = TRAIN_B, TRAIN_T_MEL, TRAIN_T_TEXT
    logits = torch.randn((B, Tm, Tt), generator=gen, device=dev) * 2
    if ragged:
        tl = torch.tensor([Tt - 9 * i for i in range(B)], dtype=torch.int32)
        ml = torch.tensor([Tm - 41 * i for i in range(B)], dtype=torch.int32)
        tl[-1], ml[-2] = 1, 40             # one token; fewer frames than text
    else:                                  # the benchmark batch: full lengths
        tl = torch.full((B,), Tt, dtype=torch.int32)
        ml = torch.full((B,), Tm, dtype=torch.int32)
    tl, ml = tl.to(dev), ml.to(dev)
    _, emit, _ = _ctc_setup(logits, tl, -1.0)
    return logits, emit, tl, ml


def _ctc_library(logits, tl, ml):
    """F.ctc_loss on the equivalent problem: targets 1..S per item, the
    blank (log-prob -1 before the softmax) as class 0."""
    import torch.nn.functional as F
    B, Tm, Tt = logits.shape
    lp = torch.log_softmax(torch.cat([logits.new_full((B, Tm, 1), -1.0),
                                      logits], dim=-1), dim=-1)
    lp = lp.transpose(0, 1).contiguous().requires_grad_()
    targets = torch.arange(1, Tt + 1, device=logits.device).repeat(B, 1)

    def fwd():
        return F.ctc_loss(lp, targets, ml.long(), tl.long(), blank=0,
                          reduction="sum", zero_infinity=True)
    with torch.no_grad():
        f_ms = cuda_ms(fwd, 20)
    loss = fwd()
    b_ms = cuda_ms(lambda: torch.autograd.grad(loss, lp, retain_graph=True),
                   20)
    return f_ms, b_ms


def _band_err(got, want) -> tuple:
    """CTC band: both at the NEG_INF floor together, else within
    KERNEL_RTOL of the magnitude (with a 1e-5 floor)."""
    floor = want < -1e29
    if not torch.equal(got < -1e29, floor):
        return float("inf"), False
    return _rel_err_ok(got[~floor], want[~floor])


def _ctc_rows(gen, dev) -> list:
    from radmmm_torch.losses import ctc_kernel
    rows = []
    for which, fn, ref, src in (
            ("alpha", ctc_kernel.ctc_alpha, ctc_kernel.ctc_alpha_reference,
             "radmmm_tpu/losses/ctc_pallas.py:33"),
            ("beta", ctc_kernel.ctc_beta, ctc_kernel.ctc_beta_reference,
             "radmmm_tpu/losses/ctc_pallas.py:75")):
        _, emit, tl, ml = _ctc_inputs(gen, dev, ragged=True)
        err_r, ok_r = _band_err(fn(emit, tl, ml), ref(emit, tl, ml))
        logits, emit, tl, ml = _ctc_inputs(gen, dev, ragged=False)
        want = ref(emit, tl, ml)
        err, ok = _band_err(fn(emit, tl, ml), want)
        k_ms = cuda_ms(lambda: fn(emit, tl, ml), 20)
        p_ms = cuda_ms(lambda: ref(emit, tl, ml), 2)
        lib_f, lib_b = _ctc_library(logits, tl, ml)
        lib_ms = lib_f if which == "alpha" else lib_b
        B, T, S = emit.shape
        # read emit once, write every row once; a lse3 (3 exp, 1 log, 8
        # adds/compares) per state of each row after the first
        b_ms, b_by = _bound(4 * (2 * B * T * S + 2 * B),
                            12.0 * B * (T - 1) * S)
        extra = ""
        if which == "beta":
            ok_r, extra = _beta_wavefront(gen, dev, T, S, k_ms, ok_r)
        log(f"[kernels] K{1 if which == 'alpha' else 2} ctc_{which} B={B} "
            f"T_mel={T} S={S}: max_abs_err {err:.3e} (rtol "
            f"{KERNEL_RTOL:g} of |band| up to "
            f"{want[want > -1e29].abs().max().item():.0f}; ragged lengths "
            f"{err_r:.3e}), kernel_ms {k_ms:.4f}, plain_ms {p_ms:.3f}, "
            f"library_ms {lib_ms:.4f} (F.ctc_loss "
            f"{'forward' if which == 'alpha' else 'backward'}), bound_ms "
            f"{b_ms:.5f} ({b_by}){extra}")
        if not (ok and ok_r):
            fail(f"ctc_{which} disagrees with its twin")
        rows.append(dict(kernel=f"ctc_{which}", src=src, max_abs_err=err,
                         ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def _beta_wavefront(gen, dev, T, S, k_ms, ok) -> tuple:
    """K2's wavefront readings: its plan, us a row, and one ragged batch
    whose longest item has half the frames, held to the twin. Returns
    (all within tolerance, text)."""
    from radmmm_torch.losses import ctc_kernel
    warps, per_lane = ctc_kernel.card_beta_plan(S)
    _, emit_r, tl_r, ml_r = _ctc_inputs(gen, dev, ragged=True)
    ml_r = (ml_r + 1) // 2
    _, ok_r = _band_err(ctc_kernel.ctc_beta(emit_r, tl_r, ml_r),
                        ctc_kernel.ctc_beta_reference(emit_r, tl_r, ml_r))
    r_ms = cuda_ms(lambda: ctc_kernel.ctc_beta(emit_r, tl_r, ml_r), 20)
    top = int(ml_r.max().item())
    return ok and ok_r, (
        f"; wavefront {warps} warps x {per_lane} states a lane, "
        f"{k_ms * 1e3 / (T - 1):.3f} us a row; ragged lengths up to "
        f"{top} of {T} frames {r_ms:.4f} ms ({r_ms / k_ms:.3f} of the "
        f"full-length time; {'within' if ok_r else 'NOT within'} rtol)")


def _mas_rows(gen, dev) -> list:
    from radmmm_torch.ops import alignment
    B, Tm, Tt = TRAIN_B, TRAIN_T_MEL, TRAIN_T_TEXT
    a = torch.softmax(torch.randn((B, Tm, Tt), generator=gen, device=dev)
                      * 3, dim=-1)
    tl = torch.full((B,), Tt, dtype=torch.int32, device=dev)
    ml = torch.full((B,), Tm, dtype=torch.int32, device=dev)
    # corner cases on a copy: one token, one frame, no frames, all ties
    ac, tlc, mlc = a.clone(), tl.clone(), ml.clone()
    tlc[1], mlc[2], mlc[3], tlc[4] = 1, 1, 0, 0
    ac[5] = 1.0 / Tt
    pairs = [(alignment.mas_width1(x, t, m),
              alignment.mas_width1_reference(alignment._log_attention(x, t),
                                             t, m))
             for x, t, m in ((a, tl, ml), (ac, tlc, mlc))]
    ok = all(torch.equal(got, want) for got, want in pairs)
    err = max((got - want).abs().max().item() for got, want in pairs)
    log_attn = alignment._log_attention(a, tl)
    k_ms = cuda_ms(lambda: alignment._launch(log_attn, tl, ml), 20)
    p_ms = cuda_ms(lambda: alignment.mas_width1_reference(log_attn, tl, ml),
                   2)
    # read the log attention once, write the alignment once; an add and a
    # compare per cell
    b_ms, b_by = _bound(4 * (2 * B * Tm * Tt + 2 * B), 2.0 * B * Tm * Tt)
    warps, cols, fills = alignment.card_plan(Tt)
    log(f"[kernels] K3 mas_width1 B={B} T_mel={Tm} T_text={Tt}: bit for bit "
        f"{'yes' if ok else 'NO'} (with corner cases; max_abs_err "
        f"{err:.3e}), kernel_ms {k_ms:.4f}, "
        f"plain_ms {p_ms:.3f}, library_ms "
        f"none (no PyTorch call computes MAS), bound_ms {b_ms:.5f} ({b_by})"
        f"; wavefront {warps} warps x {cols} columns a lane and {fills} "
        f"zero-fill warps, {k_ms * 1e3 / (Tm - 1):.3f} us a row")
    if not ok:
        fail("mas_width1 disagrees with its twin")
    return [dict(kernel="mas_width1", src="radmmm_tpu/ops/alignment.py:47",
                 max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=None,
                 bound_ms=b_ms, bound_by=b_by)]


# the SM clock at boost (H100 SXM) and the fewest cycles of a dependent f32
# add or max, for a bound set by a chain of dependent operations
SM_CLOCK_HZ = 1.98e9
F32_DEP_CYCLES = 4


def _viterbi_rows(gen, dev) -> list:
    """K6 at the training cell's shape (B 8, 513 frames, 181 pitch bins)
    on random, non-banded tables: its paths against the twin's bit for
    bit, the times of kernel and twin, the bound."""
    from radmmm_torch.data import pitch
    from radmmm_torch.utils import cuda_build
    B, F, K = TRAIN_B, TRAIN_T_MEL + 1, 181
    obs, P, V = (torch.log(torch.rand(shape, generator=gen, device=dev))
                 for shape in ((B, F, 2, K), (K, K), (2, 2)))
    got = pitch.viterbi(obs, P, V)
    want = pitch.viterbi_reference(obs, P, V)
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    k_ms = cuda_ms(lambda: pitch._launch(obs, P, V), 20)
    p_ms = cuda_ms(lambda: pitch.viterbi_reference(obs, P, V), 2)
    # read log_obs, log_P and the first score once, write both paths once;
    # an add and a max a (state, previous bin) pair of every frame after
    # the first
    t_io, io_by = _bound(4 * (B * F * 2 * K + K * K + B * 2 * K)
                         + 8 * 2 * B * F, 2.0 * B * (F - 1) * 2 * K * K)
    # each frame waits on the one before: an add, a tree max over K, the
    # voicing add and max, the observation's add, a tree max over 2 K and
    # the subtract, one after another (the backtrack's reads not counted)
    chain = 5 + math.ceil(math.log2(K)) + math.ceil(math.log2(2 * K))
    t_chain = (F - 1) * chain * F32_DEP_CYCLES / SM_CLOCK_HZ * 1e3
    b_ms, b_by = (t_chain, "frame chain") if t_chain >= t_io else (t_io,
                                                                   io_by)
    C = cuda_build.load("pyin_viterbi", pitch._declare).pyin_viterbi_cluster(K)
    log(f"[kernels] K6 pyin_viterbi B={B} F={F} K={K}: bit for bit "
        f"{'yes' if ok else 'NO'} (max_abs_err {err:.3e}), kernel_ms "
        f"{k_ms:.4f} (its first score's two elementwise kernels in), "
        f"plain_ms {p_ms:.3f}, library_ms none (no PyTorch call computes a "
        f"Viterbi path), bound_ms {b_ms:.5f} ({b_by}: {F - 1} frames x "
        f"{chain} dependent f32 ops x {F32_DEP_CYCLES} cycles at "
        f"{SM_CLOCK_HZ / 1e9:.2f} GHz; bytes and operations {t_io:.5f} ms, "
        f"{io_by}); a cluster of {C} CTAs an item, "
        f"{k_ms * 1e3 / (F - 1):.3f} us a frame")
    if not ok:
        fail("pyin_viterbi disagrees with its twin")
    return [dict(kernel="pyin_viterbi", src="radmmm_tpu/data/pitch.py:233",
                 B=B, F=F, K=K, cluster=C, max_abs_err=err, ms=k_ms,
                 plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                 bound_by=b_by)]


@contextlib.contextmanager
def cudnn_benchmark():
    """cuDNN picks each convolution's algorithm by timing them
    (torch.backends.cudnn.benchmark); the previous setting comes back
    after."""
    old = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = old


def _conv_softplus_rows(gen, dev) -> list:
    """K5 at the bench shape for each dilation (and checked at a ragged
    shape): error against the twin, times of kernel, twin, cuDNN (with its
    default algorithm choice and with cudnn.benchmark, the library time)
    and a bf16 GEMM of the same size, the bound."""
    import torch.nn.functional as F
    from radmmm_torch.ops import wn_kernel
    from radmmm_torch.scripts.bench_wn_kernel import C, DILATIONS, K
    flops = 2.0 * K * C * C * WN_B * WN_T
    # cuBLAS on equal work: (B T, K Cin) x (K Cin, Cout) in bf16, operands
    # made outside the timed call; a yardstick the port never calls
    a_mat = torch.randn((WN_B * WN_T, K * C), generator=gen,
                        device=dev).to(torch.bfloat16)
    b_mat = torch.randn((K * C, C), generator=gen, device=dev).to(
        torch.bfloat16)
    gemm_ms = cuda_ms(lambda: torch.matmul(a_mat, b_mat), 20)
    del a_mat, b_mat
    rows = []
    for d in DILATIONS:
        errs = []
        for B, T in ((3, 250), (WN_B, WN_T)):
            x = torch.randn((B, T, C), generator=gen, device=dev).to(
                torch.bfloat16)
            w = (torch.randn((K, C, C), generator=gen, device=dev)
                 * 0.02).to(torch.bfloat16)
            b = torch.randn((C,), generator=gen, device=dev) * 0.1
            got = wn_kernel.conv_softplus(x, w, b, d)
            want = wn_kernel.conv_softplus_reference(x, w, b, d)
            torch.cuda.synchronize()
            errs.append((got - want).abs().max().item())
        k_ms = cuda_ms(lambda: wn_kernel.conv_softplus(x, w, b, d), 20)
        p_ms = cuda_ms(lambda: wn_kernel.conv_softplus_reference(x, w, b, d),
                       5)
        # cuDNN in its own layout, prepared outside the timed call
        x_ncw = x.transpose(1, 2).contiguous()
        w_oik = w.permute(2, 1, 0).contiguous()

        def library():
            return F.softplus(F.conv1d(
                x_ncw, w_oik, padding=d * (K - 1) // 2, dilation=d).float()
                + b[:, None])
        default_ms = cuda_ms(library, 20)
        with cudnn_benchmark():
            lib_ms = cuda_ms(library, 20)
        # x and w in bf16 read once, the bias read and the f32 output
        # written once; 2 K C^2 operations per output row
        b_ms, b_by = _bound(2 * WN_B * WN_T * C + 2 * K * C * C
                            + 4 * C + 4 * WN_B * WN_T * C, flops,
                            PEAK_BF16_FLOP_PER_S)
        log(f"[kernels] K5 conv_softplus B={WN_B} T={WN_T} C={C} K={K} "
            f"d={d}: max_abs_err {errs[1]:.3e} (atol {K5_ATOL:g}; ragged "
            f"B=3 T=250 {errs[0]:.3e}), kernel_ms {k_ms:.4f} "
            f"({flops / k_ms / 1e9:.1f} TFLOP/s, "
            f"{flops / k_ms / 1e9 / (PEAK_BF16_FLOP_PER_S / 1e12):.1%} of "
            f"the bf16 dense peak), plain_ms {p_ms:.3f}, library_ms "
            f"{lib_ms:.4f} (cuDNN bf16 conv + softplus, cudnn.benchmark on;"
            f" default algorithm {default_ms:.4f}; kernel "
            f"{'no slower' if k_ms <= lib_ms else 'SLOWER'}), gemm_ms "
            f"{gemm_ms:.4f} (bf16 matmul of the same size, "
            f"{flops / gemm_ms / 1e9:.1f} TFLOP/s), bound_ms {b_ms:.5f} "
            f"({b_by})")
        if max(errs) > K5_ATOL:
            fail(f"conv_softplus disagrees with its twin at dilation {d}")
        rows.append(dict(kernel="conv_softplus", dilation=d, B=WN_B, T=WN_T,
                         C=C, K=K, max_abs_err=max(errs), ms=k_ms,
                         plain_ms=p_ms, library_ms=lib_ms,
                         cudnn_default_ms=default_ms, gemm_ms=gemm_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


# K7 against its twins: the same f32 products (up to 5,120 an output)
# summed in another order, over the largest output's magnitude
K7_RTOL = 1e-5
# K7's shapes: (cell, conv, B, T, C_in, C_out, K, dilation, masked). The
# flagship's WN at B 8 x T/2 256 (in_i at dilations 1 and 8; start at the
# first flow's 1,136 inputs and a later flow's odd 1,135; end at 160 and
# 158 outputs), radtts.train.f0cache's largest batch (B 8 x T/2 448;
# start at 1,128), forward, dgrad and wgrad; serving's four B = 1 frame
# buckets (T/2 96, 192, 288, 400), forward only
WN_CONV_TRAIN = (("train", 8, 256, (("in_0", 1024, 1024, 5, 1, True),
                                    ("in_3", 1024, 1024, 5, 8, True),
                                    ("res_skip", 1024, 1024, 1, 1, False),
                                    ("start", 1136, 1024, 1, 1, False),
                                    ("start_odd", 1135, 1024, 1, 1, False),
                                    ("end", 1024, 160, 1, 1, False),
                                    ("end_odd", 1024, 158, 1, 1, False))),
                 ("radtts", 8, 448, (("in_0", 1024, 1024, 5, 1, True),
                                     ("res_skip", 1024, 1024, 1, 1, False),
                                     ("start", 1128, 1024, 1, 1, False),
                                     ("end", 1024, 160, 1, 1, False))))
WN_CONV_SERVE = tuple(
    ("serve", 1, t, (("in_0", 1024, 1024, 5, 1, True),
                     ("res_skip", 1024, 1024, 1, 1, False),
                     ("start", 1136, 1024, 1, 1, False),
                     ("end", 1024, 160, 1, 1, False)))
    for t in (96, 192, 288, 400))


def _wn_conv_rows(gen, dev) -> list:
    """K7 at the WN shapes the cells run: for each direction the error
    against the twin, run-to-run bit equality, and the times of the
    kernel, its bound (FLOP at 67 TFLOP/s or bytes at 3.35 TB/s), the twin
    and cuDNN's f32 convolution with cudnn.benchmark on (the library time;
    its (B, C, T) operands made outside the timed call). Kernel and library
    are timed as graphs (``graph_ms``), as the cells run them. The bound
    and ``peak_share`` count the operations of the valid rows alone (a
    masked row's output is zero and adds nothing to the wgrad);
    ``padded_share`` is the rate of the padded GEMM that the kernel runs,
    all B T rows, as a share of 67 TFLOP/s."""
    import torch.nn.functional as F
    from radmmm_torch.ops import wn_conv as k7
    rows = []
    for cell, B, T, convs in WN_CONV_TRAIN + WN_CONV_SERVE:
        for conv, cin, cout, K, d, masked in convs:
            pad = d * (K - 1) // 2
            x = torch.randn((B, T, cin), generator=gen, device=dev)
            w = torch.randn((cout, cin, K), generator=gen,
                            device=dev) / math.sqrt(cin * K)
            bias = torch.randn((cout,), generator=gen, device=dev) * 0.1
            dy = torch.randn((B, T, cout), generator=gen, device=dev)
            mask = None
            if masked:
                mask = (torch.arange(T)[None, :] < _lengths(T, B)[:, None]
                        ).float().to(dev)
            xm = x if mask is None else x * mask[..., None]
            wt = w.permute(2, 1, 0).contiguous()
            wd = (w.flip(2) if K > 1 else w).permute(2, 0, 1).contiguous()
            x_ncw, dy_ncw = xm.transpose(1, 2).contiguous(), \
                dy.transpose(1, 2).contiguous()
            dirs = {
                "fwd": (lambda: k7.conv_f32(x, wt, bias, mask, d, True,
                                            masked, row_scales=masked)[0],
                        lambda: k7.conv_reference(x, wt, bias, mask, d, True,
                                                  masked),
                        lambda: F.conv1d(x_ncw, w, padding=pad, dilation=d)),
                "dgrad": (lambda: k7.conv_f32(dy, wd, None, mask, d, False,
                                              False, name="wn_conv_dgrad")[0],
                          lambda: k7.conv_reference(dy, wd, None, mask, d,
                                                    False, False),
                          lambda: torch.nn.grad.conv1d_input(
                              x_ncw.shape, w, dy_ncw, padding=pad,
                              dilation=d)),
                "wgrad": (lambda: k7.wgrad_f32(dy, x, mask, K, d),
                          lambda: k7.wgrad_reference(dy, x, mask, K, d),
                          lambda: torch.nn.grad.conv1d_weight(
                              x_ncw, w.shape, dy_ncw, padding=pad,
                              dilation=d))}
            if cell == "serve":
                dirs = {"fwd": dirs["fwd"]}
            rows_valid = B * T if mask is None else int(mask.sum())
            flops = 2.0 * rows_valid * cin * cout * K
            padded_flops = 2.0 * B * T * cin * cout * K
            n_bytes = 4.0 * (B * T * (cin + cout) + K * cin * cout)
            for direction, (kernel, plain, library) in dirs.items():
                got, again, want = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max() / want.abs().max())
                same = bool(torch.equal(got, again))
                k_ms = graph_ms(kernel, 20)
                p_ms = cuda_ms(plain, 5)
                with cudnn_benchmark():
                    lib_ms = graph_ms(library, 20)
                b_ms, b_by = _bound(n_bytes, flops)
                share = flops / (k_ms * 1e-3) / PEAK_F32_FLOP_PER_S
                padded = padded_flops / (k_ms * 1e-3) / PEAK_F32_FLOP_PER_S
                log(f"[kernels] K7 wn_conv {direction} {cell} {conv} B={B} "
                    f"T={T} {cin}->{cout} K={K} d={d}: rel_err {err:.2e} "
                    f"(rtol {K7_RTOL:g}), same bits twice "
                    f"{'yes' if same else 'NO'}, kernel_ms {k_ms:.4f} "
                    f"({share:.1%} of 67 TFLOP/s over the {rows_valid} "
                    f"valid rows; the padded GEMM of {B * T} rows "
                    f"{padded:.1%}), "
                    f"bound_ms {b_ms:.4f} ({b_by}), plain_ms {p_ms:.4f}, "
                    f"library_ms {lib_ms:.4f} (cuDNN f32, cudnn.benchmark; "
                    f"kernel {'no slower' if k_ms <= lib_ms else 'SLOWER'})")
                if err > K7_RTOL or not same:
                    fail(f"wn_conv {direction} at {cell} {conv} disagrees "
                         "with its twin or with itself")
                rows.append(dict(
                    kernel=f"wn_conv_{direction}", cell=cell, conv=conv, B=B,
                    T=T, C_in=cin, C_out=cout, K=K, dilation=d,
                    max_abs_err=err, same_bits=same, ms=k_ms, plain_ms=p_ms,
                    library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                    rows_valid=rows_valid, peak_share=share,
                    padded_share=padded))
            del x, w, dy, x_ncw, dy_ncw, xm, wt, wd
    return rows


@tf32_off()
def phase_kernels(seed: int) -> list:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for name, L, H, T, cin in PATH_SHAPES:
        for B in (1, 8):
            rows.append(_lstm_rows(gen, dev, name, L, H, T, cin, B,
                                   train=False)[0])
    for name, L, H, T, cin in TRAIN_SHAPES:
        rows.extend(_lstm_rows(gen, dev, name, L, H, T, cin, TRAIN_B,
                               train=True))
    rows.extend(_ctc_rows(gen, dev))
    rows.extend(_mas_rows(gen, dev))
    rows.extend(_conv_softplus_rows(gen, dev))
    rows.extend(_viterbi_rows(gen, dev))
    rows.extend(_wn_conv_rows(gen, dev))
    return rows


def _nudge_couplings(model) -> None:
    """Small random weights in the couplings' zero-initialised output
    convs, so that no coupling is the identity."""
    from radmmm_torch.ops.coupling import WN
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, WN):
                m.end.weight.normal_(0.0, 1e-3)
                m.end.bias.normal_(0.0, 1e-3)


def build_models(seed: int):
    """Full-width RADMMM + HiFi-GAN v1 with random weights from ``seed``.
    The couplings' zero-initialised output convs get small random weights
    so the context reaches the mel (at init they make every coupling the
    identity), and the duration head's bias is log(1 + 7), which puts
    token durations at a few frames, the pace of speech at 22,050 Hz with
    hop 256, so the requests spread over the frame buckets as real text
    does (at init most tokens round to one frame)."""
    from radmmm_torch.models.tts import TTSModel, default_radmmm_config
    from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
    torch.manual_seed(seed)
    model = TTSModel(default_radmmm_config()).eval()
    _nudge_couplings(model)
    with torch.no_grad():
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


def phase_serve(seed: int, model, vocoder, model_gpu, tag: str = "serve",
                kernel: str = "lstm_recurrence") -> int:
    """Four HTTP requests to the daemon over an artifact of ``model`` and
    ``vocoder``, checked, at the conv precision set; returns the
    launches of ``kernel`` (K4, or its bf16 variant) on them, the only
    kernel of K1-K6 the path may launch."""
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
        log(f"[{tag}] artifact {n_bytes / 2**20:.1f} MiB written in "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        httpd = serve(path, host="127.0.0.1", port=0, device="cuda")
        log(f"[{tag}] artifact loaded on the card in "
            f"{time.perf_counter() - t0:.2f} s")
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        for k, req in enumerate(requests):   # cold: first use of each shape
            t0 = time.perf_counter()
            status, _ = _post(httpd.server_address, req)
            log(f"[{tag}] cold request {k}: HTTP {status}, "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        # the main path: counts from zero, four requests, counts read after
        _zero_counters()
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
            log(f"[{tag}] request {k}: {n_items} text(s), "
                f"{[len(s) for s in ids]} "
                f"tokens, frames {expect[k].tolist()}, {ms:.1f} ms")
        counts = _counters()
        launches = counts.pop(kernel)
        k7 = counts.pop("wn_conv_fwd")
        other = {k: v for k, v in counts.items() if v}
        # where the device time of one warm 96-token request goes, through
        # the callable the daemon dispatches to
        profile(lambda: httpd.service.tts(*calls[2]),
                f"one request ({calls[2][0].shape[1]} tokens, traced)")
    finally:
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=10)
    want = 4 * len(requests)   # encoder + duration DAP + frame DAPs + context
    # stage B's flow inverse: 8 WN stacks through K7 in f32 mode
    want_k7 = len(requests) * _wn_launches(model, False).get("wn_conv_fwd", 0)
    log(f"[{tag}] {kernel} launches on the main path: {launches} "
        f"(expected {want}), K7 forward {k7} (expected {want_k7}), other "
        f"kernels {other or 'none'}")
    if launches < want or other or k7 != want_k7:
        fail(f"the {tag} path did not go through its LSTM kernel and K7 "
             "alone")
    return launches


# names of cuDNN's convolution kernels (implicit GEMMs, its legacy
# engines, Winograd, FFT) and of its NCHW <-> NHWC transposes, as the
# profiler reports them on an H100
CONV_KERNEL_KEYS = ("cudnn", "implicit_convolve", "xmma_fprop",
                    "xmma_dgrad", "xmma_wgrad", "dgrad_engine",
                    "wgrad_alg", "winograd", "convolve")


def profile(fn, what: str, top: int = 12):
    """torch.profiler over one call of ``fn``: device time by kernel
    (kernels only, not the operators that launch them, so nothing counts
    twice), and device busy time against the wall time of the traced
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), "
        f"{sum(r[2] for r in rows)} kernels")
    conv = [r for r in rows if any(k in r[0] for k in CONV_KERNEL_KEYS)]
    conv_ms = sum(r[1] for r in conv)
    log(f"[profile]   cuDNN's convolution kernels and their layout "
        f"transposes: {conv_ms:.2f} ms ({100 * conv_ms / busy_ms:.1f}% of "
        f"busy) in {sum(r[2] for r in conv)} launches")
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


# the kernels' names in the launch registry (radmmm_torch/utils/launches.py)
# that the script's steps, requests and validations count
COUNTED = ("lstm_recurrence", "lstm_recurrence_bwd", "lstm_recurrence_bf16",
           "lstm_recurrence_bwd_bf16", "ctc_alpha", "ctc_beta", "mas_width1",
           "conv_softplus", "pyin_viterbi", "wn_conv_fwd", "wn_conv_dgrad",
           "wn_conv_wgrad")
# the featurizer's kernels (pYIN's Viterbi): where a fit's data loader
# threads featurize beside the counted steps, at times no count can pin
# (the fit, bf16 and caches phases, the ddp phase's part (c) and the graphs
# phase's parts (e) and (f)), the counts leave them out
LOADER_FEATURIZED = ("pyin_viterbi",)


def _counters(loaders: bool = False) -> dict:
    """The kernels' launches so far; with ``loaders``, those of a phase
    whose loader threads featurize, without LOADER_FEATURIZED."""
    from radmmm_torch.utils.launches import launch_counts
    if set(launch_counts) - set(COUNTED):
        fail(f"launches of kernels the script does not know: "
             f"{sorted(set(launch_counts) - set(COUNTED))}")
    return {k: launch_counts[k] for k in COUNTED
            if not (loaders and k in LOADER_FEATURIZED)}


def _zero_counters() -> None:
    from radmmm_torch.utils.launches import launch_counts
    launch_counts.clear()


# K7's launches in one forward of a WN stack of 4 layers (start, in_0-3,
# res_skip_0-3, end), in f32 conv precision; its backward launches as many
# dgrads and wgrads
WN_CONVS = 10
# launches of each kernel in one step of make_train_step(binarize=True):
# the encoder, duration-DAP, ganged frame-DAP and flow-context recurrences
# forward and backward, one CTC loss (alpha; beta in its backward), one
# MAS, K7 through the 8 flows' WN stacks forward and backward; the
# package's WN layers do not run K5; it featurizes nothing, so no pYIN (a
# megastep's step featurizes with pYIN: one pyin_viterbi more); in f32 the
# bf16 variants of K4 never run (PER_STEP_BF16: in bf16 mode the reverse,
# and no K7)
PER_STEP = {"lstm_recurrence": 4, "lstm_recurrence_bwd": 4,
            "lstm_recurrence_bf16": 0, "lstm_recurrence_bwd_bf16": 0,
            "ctc_alpha": 1, "ctc_beta": 1, "mas_width1": 1,
            "conv_softplus": 0, "pyin_viterbi": 0,
            "wn_conv_fwd": 8 * WN_CONVS, "wn_conv_dgrad": 8 * WN_CONVS,
            "wn_conv_wgrad": 8 * WN_CONVS}
PER_STEP_BF16 = dict(PER_STEP, lstm_recurrence=0, lstm_recurrence_bwd=0,
                     lstm_recurrence_bf16=4, lstm_recurrence_bwd_bf16=4,
                     wn_conv_fwd=0, wn_conv_dgrad=0, wn_conv_wgrad=0)


def _wn_launches(model, backward: bool) -> dict:
    """K7's launches in one forward (and, with ``backward``, backward) of
    ``model``'s WN stacks in f32 conv precision: one a conv and direction,
    but for a stack split over a tensor-parallel group, whose row-parallel
    ``end`` partial stays on ``conv1d`` (``WN._forward_split``)."""
    from radmmm_torch.ops.conv import get_conv_precision
    from radmmm_torch.ops.coupling import WN
    if get_conv_precision() != "f32":
        return {}
    n = sum(1 + 2 * m.n_layers + (m.tp is None)
            for m in model.modules() if isinstance(m, WN))
    return {"wn_conv_fwd": n, **({"wn_conv_dgrad": n, "wn_conv_wgrad": n}
                                if backward else {})}
# the same, as a fit's steps are counted (``_counters(loaders=True)``)
FIT_STEP = {k: n for k, n in PER_STEP.items() if k not in LOADER_FEATURIZED}
FIT_STEP_BF16 = {k: n for k, n in PER_STEP_BF16.items()
                 if k not in LOADER_FEATURIZED}


def train_batch(seed: int, B: int, T_text: int, T_mel: int, device,
                text_lens=None, mel_lens=None) -> dict:
    """The benchmark's training batch (random features from ``seed``, a
    normalised random alignment prior), full lengths unless given."""
    rng = np.random.default_rng(seed)
    prior = rng.uniform(0.1, 1.0, (B, T_mel, T_text)).astype(np.float32)
    prior /= prior.sum(-1, keepdims=True)
    arrays = {
        "text": rng.integers(0, 426, (B, T_text)).astype(np.int32),
        "input_lengths": np.asarray(
            [T_text] * B if text_lens is None else text_lens, np.int32),
        "mel": rng.standard_normal((B, T_mel, 80)).astype(np.float32),
        "output_lengths": np.asarray(
            [T_mel] * B if mel_lens is None else mel_lens, np.int32),
        "speaker_ids": rng.integers(0, 21, (B,)).astype(np.int32),
        "accent_ids": rng.integers(0, 7, (B,)).astype(np.int32),
        "f0": rng.uniform(4, 6, (B, T_mel)).astype(np.float32),
        "voiced_mask": rng.integers(0, 2, (B, T_mel)).astype(np.float32),
        "energy_avg": rng.uniform(0, 1, (B, T_mel)).astype(np.float32),
        "attn_prior": prior,
        "speaker_f0_mean": np.full((B,), 5.0, np.float32),
        "speaker_f0_std": np.full((B,), 0.3, np.float32),
    }
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def _loss_config():
    from radmmm_torch.training.step import LossConfig
    # the benchmark's loss settings
    return LossConfig(n_group_size=2, cross_covariance_weight=1.0,
                      speaker_reg={"variance": 0.0, "covariance": 0.0})


def _flagship_training(seed: int, batch: dict, tag: str,
                       per_step: dict = PER_STEP):
    """The full-width model from ``seed`` on the card, its whitening init
    on ``batch``, one warm-up step, then TRAIN_STEPS timed steps of
    make_train_step(binarize=True, kl_on=True) with the kernels' counts
    from zero, at the conv precision set: every metric finite and each
    kernel launched as ``per_step`` says. Returns (model, step, state,
    generator, launches, mean ms)."""
    from radmmm_torch.ops.conv import get_conv_precision
    from radmmm_torch.models.tts import TTSModel, default_radmmm_config
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_step,
                                            make_whitening_init)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(seed)
    model = TTSModel(default_radmmm_config())
    _nudge_couplings(model)
    state = create_train_state(model, device="cuda")
    make_whitening_init(model)(state, batch)
    step = make_train_step(model, _loss_config(), binarize=True, kl_on=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"[{tag}] full-width model ({n_params / 1e6:.1f} M parameters) on "
        f"the card with the whitening init in {time.perf_counter() - t0:.2f}"
        " s")
    t0 = time.perf_counter()
    state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    log(f"[{tag}] warm-up step {(time.perf_counter() - t0) * 1e3:.1f} ms")
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from zero, the timed steps, counts read after
    _zero_counters()
    times, mets = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        mets.append({k: v.item() for k, v in met.items()})
    launches = _counters()
    for i, (ms, m) in enumerate(zip(times, mets)):
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        log(f"[{tag}] step {i}: {ms:.1f} ms, loss {m['loss']:.4f}, "
            f"grad_norm {m['grad_norm']:.4f}, "
            + ", ".join(f"{k} {v:.4f}" for k, v in m.items()
                        if k not in ("loss", "grad_norm")))
        if bad:
            fail(f"{tag} training step {i}: non-finite {bad}")
    want = {k: n * TRAIN_STEPS for k, n in per_step.items()}
    log(f"[{tag}] kernel launches on {TRAIN_STEPS} steps: {launches} "
        f"(expected {want})")
    if launches != want:
        fail(f"the {tag} training step did not launch each kernel as "
             "expected")
    B, T_mel = batch["mel"].shape[:2]
    ms = sum(times) / len(times)
    log(f"[{tag}] {ms:.2f} ms/step (mean of {TRAIN_STEPS} warm steps), "
        f"{B * T_mel / ms * 1e3:.0f} mel frames/s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (B={B}, "
        f"T_text={batch['text'].shape[1]}, T_mel={T_mel}, "
        f"{get_conv_precision()})")
    return model, step, state, gen, launches, ms


@tf32_off()
def phase_train(seed: int) -> tuple:
    """The flagship training step at full width, f32 (TF32 off), on the
    benchmark's batch. Returns the kernels' launches on the timed steps
    and the mean ms a step."""
    batch = train_batch(seed, TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL,
                        torch.device("cuda"))
    _, step, state, gen, launches, ms = _flagship_training(seed, batch,
                                                           "train")
    profile(lambda: step(state, batch, gen),
            f"one training step (B={TRAIN_B}, T_mel={TRAIN_T_MEL}, traced)",
            top=15)
    return launches, ms


def no_dropout_config():
    """The full-width config with every dropout rate at 0."""
    from radmmm_torch.models.tts import default_radmmm_config
    c = default_radmmm_config(encoder_p_dropout=0.0)
    return dataclasses.replace(c, **{
        k: dict(getattr(c, k), p_dropout=0.0)
        for k in ("f0_predictor", "energy_predictor", "voiced_predictor",
                  "duration_predictor")})


@tf32_off()
def phase_train_parity(seed: int):
    """One training step at full width and short lengths on the card and
    on the CPU from the same weights and batch, dropout off (the card's
    and the CPU's generators draw other bits)."""
    from radmmm_torch.models.tts import TTSModel
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_step,
                                            make_whitening_init)
    torch.manual_seed(seed + 2)
    cpu_model = TTSModel(no_dropout_config())
    _nudge_couplings(cpu_model)
    models = {"cuda": copy.deepcopy(cpu_model), "cpu": cpu_model}
    res = {}
    for where, m in models.items():
        batch = train_batch(seed + 3, 2, 12, 64, where, text_lens=[12, 9],
                            mel_lens=[64, 50])
        state = create_train_state(m, device=where)
        make_whitening_init(m)(state, batch)
        step = make_train_step(m, _loss_config(), binarize=True, kl_on=True)
        t0 = time.perf_counter()
        state, met = step(state, batch, torch.Generator(device=where))
        res[where] = {k: v.item() for k, v in met.items()}
        log(f"[train_parity] {where}: one step in "
            f"{time.perf_counter() - t0:.2f} s, loss {res[where]['loss']:.6f}"
            f", grad_norm {res[where]['grad_norm']:.6f}")
    worst = 0.0
    for k, want in res["cpu"].items():
        got = res["cuda"][k]
        err = abs(got - want)
        worst = max(worst, err / (1e-5 + abs(want)))
        log(f"[train_parity]   {k}: card {got:.6f}, cpu {want:.6f}, abs err "
            f"{err:.3e}")
        if not (math.isfinite(got) and err <= 1e-5 + TRAIN_PARITY_RTOL
                * abs(want)):
            fail(f"card and CPU disagree on {k}")
    log(f"[train_parity] worst relative error {worst:.3e} (rtol "
        f"{TRAIN_PARITY_RTOL:g}: f32 on both, TF32 off, sums in another "
        "order through the encoder, the attention, 8 flows and the "
        "backward)")
    errs = leaf_grad_errors(models["cuda"], models["cpu"])
    log(f"[train_parity] gradients of {len(errs)} parameters; worst, as max "
        f"|card - cpu| over the leaf's max |cpu| (at least {GRAD_FLOOR:g} "
        f"of the tree's; bound {GRAD_PARITY_RTOL:g}):")
    for err, name, mag in errs[:6]:
        log(f"[train_parity]   {err:.3e} {name} (max |grad| {mag:.3e})")
    by_module = {}
    for err, name, _ in errs:
        by_module.setdefault(name.split(".")[0], []).append(err)
    log("[train_parity] by module, worst and median: " + ", ".join(
        f"{k} {max(v):.2e} {sorted(v)[len(v) // 2]:.2e}"
        for k, v in by_module.items()))
    if not errs[0][0] <= GRAD_PARITY_RTOL:
        fail(f"card and CPU gradients disagree on {errs[0][1]}")


def leaf_grad_errors(got_model, want_model, frobenius: bool = False
                     ) -> list:
    """(error, name, max |want grad|) for every parameter of two copies of
    one model after a step, worst first: the largest difference of the
    gradients over the largest magnitude of ``want_model``'s (with
    ``frobenius``, the difference's Frobenius norm over the gradient's),
    that magnitude taken as at least GRAD_FLOOR of the largest in the
    whole tree. The floor is for leaves whose gradient is zero in exact
    arithmetic (a conv bias or weight-norm gain before an instance or
    batch norm): both sides hold rounding noise there, 1e-13 against
    1e-13. A parameter with a gradient on one side only counts as
    infinitely wrong."""
    return grad_errors({n: p.grad for n, p in got_model.named_parameters()},
                       {n: p.grad for n, p in want_model.named_parameters()},
                       frobenius)


def grad_errors(got: dict, want: dict, frobenius: bool = False) -> list:
    """``leaf_grad_errors`` on two {name: gradient or None} dicts."""
    tree = max(w.abs().max().item() for w in want.values()
               if w is not None)
    out = []
    for name, g in got.items():
        w = want[name]
        if g is None or w is None:
            out.append((0.0 if g is w else math.inf, name, 0.0))
            continue
        d, w = g.detach().cpu() - w.detach(), w.detach()
        diff, mag = ((d.norm().item(), w.norm().item()) if frobenius
                     else (d.abs().max().item(), w.abs().max().item()))
        out.append((diff / max(mag, GRAD_FLOOR * tree), name,
                    w.abs().max().item()))
    return sorted(out, key=lambda e: -e[0])


def phase_wn() -> int:
    """The bench entry point's path at B 32, T 256: one fused stack call
    with the counts from zero (exactly one K5 launch per layer), then the
    script's parity line and table. Returns the K5 launches of that call."""
    from radmmm_torch.scripts import bench_wn_kernel as wn
    params, x = wn.make_inputs(WN_B, WN_T, "cuda")
    with torch.no_grad():
        wn.wn_stack_fused(params, x)                 # first use
        torch.cuda.synchronize()
        # the main path: counts from zero, one stack call, counts read after
        _zero_counters()
        h, skip = wn.wn_stack_fused(params, x)
        torch.cuda.synchronize()
    launches = _counters()
    want = dict.fromkeys(launches, 0)
    want["conv_softplus"] = len(wn.DILATIONS)
    log(f"[wn] kernel launches on one fused stack call: {launches} "
        f"(expected {want})")
    if launches != want:
        fail("the fused WN stack did not launch K5 once per layer")
    if not (torch.isfinite(h).all() and torch.isfinite(skip).all()):
        fail("the fused WN stack gave non-finite values")
    res = wn.run(params, x, iters=20)
    for part in ("h", "skip"):
        err, mag = res[f"err_A_C_{part}"], res[f"max_A_{part}"]
        log(f"[wn] fused stack against variant A, {part}: max_abs_err "
            f"{err:.3e} (bound {WN_PARITY_RTOL:g} of max |A| {mag:.2f}: A "
            "rounds each conv output to bf16)")
        if not err <= WN_PARITY_RTOL * mag:
            fail(f"the fused WN stack disagrees with variant A in {part}")
    return launches["conv_softplus"]


FEAT_B, FEAT_SAMPLES, FEAT_TEXT = 8, 131071, 96
# card against CPU, featurized batch (f32, TF32 off). The mel goes through
# cuFFT on the card and pocketfft on the CPU, whose rounding is relative to
# the frame's largest coefficient: it is held in the linear domain, to
# FEAT_MEL_RTOL of the utterance's largest mel value (the log of a bin far
# below that, a window sidelobe between harmonics, is rounding noise on
# both sides); the energy, a mean of 80 log bins over 20, to
# FEAT_ENERGY_ATOL; the prior, float64 on both sides, to FEAT_PRIOR_RTOL
FEAT_MEL_RTOL = 1e-5
FEAT_ENERGY_ATOL = 1e-4
FEAT_PRIOR_RTOL = 1e-5
# voicing, F0 and p_voiced are decisions on thresholds and a Viterbi path
# that can tip on the last bit of an f32 sum; each must agree on all but
# this share of the valid frames
FEAT_OFF_SHARE = 5e-3


def featurize_items(seed: int) -> list:
    """Eight synthetic voiced utterances of FEAT_SAMPLES samples at
    22,050 Hz: a three-harmonic tone with 5 Hz vibrato (110-250 Hz), an
    unvoiced noise burst, a second tone a fifth higher, then silence;
    FEAT_TEXT random tokens each."""
    rng = np.random.default_rng(seed)
    n = FEAT_SAMPLES
    t = np.arange(n) / SR
    items = []
    for b in range(FEAT_B):
        audio = np.zeros(n)
        for lo, hi, f in ((0.0, 0.4, 110.0 + 20.0 * b),
                          (0.5, 0.85, 1.5 * (110.0 + 20.0 * b))):
            seg = slice(int(lo * n), int(hi * n))
            phase = (2 * np.pi * f * t[seg]
                     + f * 0.03 / 5.0 * np.sin(2 * np.pi * 5.0 * t[seg]))
            audio[seg] = (0.4 * np.sin(phase) + 0.25 * np.sin(2 * phase)
                          + 0.12 * np.sin(3 * phase))
        gap = slice(int(0.4 * n), int(0.5 * n))
        audio[gap] = 0.05 * rng.standard_normal(gap.stop - gap.start)
        items.append({
            "audio": audio.astype(np.float32),
            "text_encoded": rng.integers(1, 426, FEAT_TEXT),
            "speaker_id": b % 21, "accent_id": b % 7,
            "speaker_f0_mean": float(np.log(130.0 + 20.0 * b)),
            "speaker_f0_std": 0.25, "speaker_energy_mean": 0.5,
            "speaker_energy_std": 0.15, "audiopath": f"synthetic_{b}.wav",
            "text_raw": "synthetic", "language": "en_US", "idx": b})
    return items


def _compare_featurized(got: dict, want: dict) -> None:
    """Card batch against CPU batch, key by key, every difference
    printed."""
    valid = (torch.arange(want["mel"].shape[1])[None, :]
             < want["output_lengths"][:, None])
    n_valid = int(valid.sum())
    for k, w in want.items():
        if not isinstance(w, torch.Tensor):
            if got[k] != w:
                fail(f"featurize: {k} differs")
            continue
        g = got[k].cpu()
        if k == "mel":
            lin_g, lin_w = g.exp() * valid[..., None], w.exp() * valid[..., None]
            scale = lin_w.amax(dim=(1, 2), keepdim=True)
            err = ((lin_g - lin_w).abs() / scale).max().item()
            ok = err <= FEAT_MEL_RTOL
            log(f"[featurize]   mel: max |card - cpu| of exp(log-mel) over "
                f"the utterance's largest {err:.3e} (rtol {FEAT_MEL_RTOL:g}); "
                f"log-mel max_abs_err {(g - w).abs().max().item():.3e}, "
                f"median {(g - w).abs().median().item():.3e}")
        elif k in ("energy_avg", "attn_prior"):
            err = (g - w).abs().max().item()
            if k == "attn_prior":
                ok = bool(((g - w).abs() <= 1e-12 + FEAT_PRIOR_RTOL
                           * w.abs()).all())
                tol = f"rtol {FEAT_PRIOR_RTOL:g}"
            else:
                ok = err <= FEAT_ENERGY_ATOL
                tol = f"atol {FEAT_ENERGY_ATOL:g}"
            log(f"[featurize]   {k}: max_abs_err {err:.3e} ({tol})")
        elif k in ("voiced_mask", "p_voiced", "f0"):
            if k == "f0":          # log F0 where both call the frame voiced
                where = (got["voiced_mask"].cpu() > 0) & (
                    want["voiced_mask"] > 0)
                off, tol = (g - w).abs() > 1e-4 * w.abs(), "1e-4 relative"
            else:
                where = valid
                atol = 0 if k == "voiced_mask" else 1e-4
                off, tol = (g - w).abs() > atol, f"atol {atol:g}"
            n_off = int((off & where).sum())
            ok = n_off <= FEAT_OFF_SHARE * n_valid
            log(f"[featurize]   {k}: {n_off} of {n_valid} valid frames "
                f"beyond {tol} (at most a share of {FEAT_OFF_SHARE:g}), "
                f"max_abs_err {(g - w)[where].abs().max().item():.3e}")
        else:
            ok = torch.equal(g, w)
            if not ok:
                log(f"[featurize]   {k}: differs")
        if not ok:
            fail(f"featurize: card and CPU disagree on {k}")


# calls of a host batch each way in the featurize phase's graphed run:
# the warm-up, the capture, then replays
FEAT_GRAPH_CALLS = 5


def _featurize_graphed(host: dict, card: str) -> dict:
    """The featurizer's calls through its graphs (a pool of its own)
    against a featurizer's eager calls (``pool=None``), in turns, with
    pYIN and with F0 cache tracks (pYIN's own, on the batch): each call's
    batch bit for bit, key by key; the graph warmed up at the first call,
    captured at the second and replayed from it; ms a call each way (wall,
    synchronised, the upload in); warm-ups, captures, replays, capture
    seconds and the pool's MiB; a traced replay's busy ms, kernels and
    host launch calls against a traced eager call's. Returns the graphed
    batch of ``host``."""
    from radmmm_torch.data import pitch
    from radmmm_torch.data.collate import Featurizer
    frames = host["audio"].shape[1] // 256
    tracks = pitch.pyin_f0(torch.from_numpy(host["audio"]).cuda())
    cached = dict(host, cached_f0=np.stack(
        [t.cpu().numpy() for t in tracks], axis=1)[:, :, :frames])
    eager = Featurizer(device="cuda", pool=None)
    out = None
    for tag, h in (("pYIN", host), ("F0 cache", cached)):
        graphed = Featurizer(device="cuda")
        pool = graphed.pool
        ms, replayed, equal = {"graphed": [], "eager": []}, [], True
        for _ in range(FEAT_GRAPH_CALLS):
            got = {}
            for way, feat in (("eager", eager), ("graphed", graphed)):
                replays = pool.replays
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[way] = feat(h)
                torch.cuda.synchronize()
                ms[way].append(1e3 * (time.perf_counter() - t0))
            replayed.append(pool.replays > replays)
            e, g = got["eager"], got["graphed"]
            equal &= set(g) == set(e) and all(
                torch.equal(g[k], v) if isinstance(v, torch.Tensor)
                else g[k] == v for k, v in e.items())
        out = out or got["graphed"]
        t0 = time.perf_counter()
        for _ in range(3):
            eager.raw_arrays(h)
        host_ms = 1e3 * (time.perf_counter() - t0) / 3
        _, prof_g = traced(lambda: graphed(h))
        _, prof_e = traced(lambda: eager(h))
        steady = [m for m, r in zip(ms["graphed"], replayed) if r][1:]
        log(f"[featurize] ({card}) {tag}: the graphed featurize call "
            f"against eager over {FEAT_GRAPH_CALLS} calls, every key "
            f"bit-equal {equal}; replayed by call "
            + "".join("R" if r else "." for r in replayed)
            + "; ms a call (wall, synchronised, the upload in), graphed "
            + ", ".join(f"{x:.2f}" for x in ms["graphed"]) + " (warm-up, "
            f"capture, replays), eager " + ", ".join(
                f"{x:.2f}" for x in ms["eager"])
            + f"; the {len(steady)} replays after the capture's: graphed "
            f"mean {np.mean(steady):.2f}, eager mean "
            f"{np.mean(ms['eager'][2:]):.2f}; warm-ups {pool.warmups}, "
            f"captures {len(pool.captures)}, replays {pool.replays}, capture "
            f"{sum(c.seconds for c in pool.captures):.3f} s, the pool "
            f"{sum(c.pool_bytes for c in pool.captures) / 2**20:.1f} MiB; "
            f"of a call, the host's raw_arrays (int16 quantisation) "
            f"{host_ms:.2f} ms")
        for way, prof in (("graphed", prof_g), ("eager", prof_e)):
            log(f"[featurize] {tag}: a traced {way} call: wall "
                f"{prof['wall_ms']:.2f} ms, the card busy "
                f"{prof['busy_ms']:.2f} ms (union {prof['union_ms']:.2f}) "
                f"in {prof['kernels']} kernels, {prof['host_launches']} host "
                f"launch calls {prof['host_calls']}")
        if not equal or replayed != [False] + [True] * (
                FEAT_GRAPH_CALLS - 1) or pool.warmups != 1 or \
                len(pool.captures) != 1:
            fail(f"featurize ({tag}): the graphed calls are not the eager "
                 f"ones (bit-equal {equal}) or did not replay from the "
                 f"second call (by call {replayed}, warm-ups {pool.warmups}, "
                 f"captures {len(pool.captures)})")
    return out


def _viterbi_graphed(audio: torch.Tensor, card: str) -> None:
    """pyin_f0 eager and as one CUDA graph: the graph's result bit for bit,
    CUDA-event ms each way, its kernels (a traced replay) and one
    ``pyin_viterbi`` launch a call, replays included. Then its Viterbi DP
    at the shape pYIN gives it (1 + T_audio // 256 frames, 2 x 181
    states, a random non-banded log_P): the kernel against its plain twin
    eager and as one CUDA graph, bit for bit, CUDA-event ms of each."""
    from radmmm_torch.data import pitch
    from radmmm_torch.utils.graphs import Graphed, GraphPool
    from radmmm_torch.utils.launches import launch_counts

    def launches(fn, calls: int) -> float:
        before = launch_counts["pyin_viterbi"]
        for _ in range(calls):
            fn()
        return (launch_counts["pyin_viterbi"] - before) / calls

    def graphed(fn, inputs: dict, name: str):
        g = Graphed(fn, GraphPool(), name=name)
        g(inputs)                                     # warm-up
        got = g(inputs)                               # captured, replayed
        return (lambda: g(inputs)), got

    pyin = lambda x: pitch.pyin_f0(x["audio"])
    inputs = {"audio": audio}
    want = pyin(inputs)
    g, got = graphed(pyin, inputs, "pyin_f0")
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    eager_ms = cuda_ms(lambda: pyin(inputs), 3)
    graphed_ms = cuda_ms(g, 3)
    a_call = (launches(lambda: pyin(inputs), 2), launches(g, 2))
    _, prof = traced(g)
    log(f"[featurize] ({card}) pyin_f0 (B={audio.shape[0]}, "
        f"{1 + audio.shape[1] // 256} frames): eager {eager_ms:.2f} ms, one "
        f"CUDA graph {graphed_ms:.2f} ms (CUDA events, mean of 3), "
        f"{prof['kernels']} kernels a replay, busy {prof['busy_ms']:.2f} ms, "
        f"{prof['host_launches']} host launch calls; pyin_viterbi "
        f"launches a call eager {a_call[0]:g}, a replay {a_call[1]:g}; the "
        f"graph's result bit-equal {equal}")
    if not equal or a_call != (1, 1):
        fail("featurize: pyin_f0 replayed from its graph is not its eager "
             "result, or a call did not launch pYIN's Viterbi once")

    B, T_audio = audio.shape
    n_bins = int(np.ceil(60 * np.log2(640.0 / 80.0))) + 1
    dev = audio.device
    x = {"obs": torch.log(torch.rand((B, 1 + T_audio // 256, 2, n_bins),
                                     device=dev)),
         "P": torch.log(torch.rand((n_bins, n_bins), device=dev)),
         "V": torch.log(torch.rand((2, 2), device=dev))}
    kernel = lambda: pitch.viterbi(x["obs"], x["P"], x["V"])
    twin_fn = lambda y: pitch.viterbi_reference(y["obs"], y["P"], y["V"])
    got = kernel()
    twin = twin_fn(x)
    twin_g, twin_got = graphed(twin_fn, x, "viterbi_reference")
    equal = all(torch.equal(a, b) and torch.equal(a, c)
                for a, b, c in zip(got, twin, twin_got))
    kernel_ms = cuda_ms(kernel, 20)
    twin_ms = cuda_ms(lambda: twin_fn(x), 3)
    twin_graphed_ms = cuda_ms(twin_g, 3)
    a_call = launches(kernel, 2)
    _, prof = traced(kernel)
    log(f"[featurize] ({card}) pYIN's Viterbi ({tuple(x['obs'].shape)}): "
        f"the kernel {kernel_ms:.4f} ms (CUDA events, mean of 20, the "
        f"wrapper included; {prof['kernels']} kernels, busy "
        f"{prof['busy_ms']:.4f} ms traced), {a_call:g} pyin_viterbi launch "
        f"a call; its twin eager {twin_ms:.2f} ms, one CUDA graph "
        f"{twin_graphed_ms:.2f} ms (mean of 3); the kernel's paths and the "
        f"graphed twin's bit-equal to the eager twin's: {equal}")
    if not equal or a_call != 1:
        fail("featurize: pYIN's Viterbi kernel is not its twin bit for bit, "
             "or did not launch once a call")


@tf32_off()
def phase_featurize(seed: int) -> dict:
    """int16 audio -> the training batch on the card: the featurizer's
    eager call, timed; its graphed call against the eager one with pYIN
    and with the F0 cache (``_featurize_graphed``); the graphed batch
    against the CPU; pYIN and its Viterbi eager and graphed
    (``_viterbi_graphed``); then TRAIN_STEPS training steps from the batch
    and one reconstruct at sigma 0. Returns the kernels' launches on the
    timed steps."""
    from radmmm_torch.data.collate import Featurizer, collate_host
    from radmmm_torch.utils.device import card_line
    card = card_line()
    host = collate_host(featurize_items(seed))
    B, T_audio = host["audio"].shape
    feat = Featurizer(device="cuda", pool=None)
    batch = feat(host)                               # first use: FFT plans
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = feat(host)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    feat_ms = sum(times) / len(times)
    t0 = time.perf_counter()
    cpu = Featurizer(device="cpu")(host)
    cpu_s = time.perf_counter() - t0
    T_mel = batch["mel"].shape[1]
    log(f"[featurize] B={B}, {T_audio} samples (int16), T_mel={T_mel}, "
        f"T_text={batch['text'].shape[1]}: {feat_ms:.2f} ms on the card "
        f"eager (mean of 3: {', '.join(f'{t:.1f}' for t in times)}), "
        f"{B * T_mel / feat_ms * 1e3:.0f} mel frames/s; on the host CPU "
        f"{cpu_s:.2f} s; voiced share "
        f"{batch['voiced_mask'].sum().item() / B / T_mel:.3f}")
    batch = _featurize_graphed(host, card)
    _compare_featurized(batch, cpu)
    _viterbi_graphed(batch["audio"], card)
    profile(lambda: feat(host), f"one eager featurize call (B={B}, "
            f"T_mel={T_mel}, traced)", top=10)

    model, _, _, _, launches, step_ms = _flagship_training(seed, batch,
                                                           "featurize")
    log(f"[featurize] featurize {feat_ms:.2f} ms (eager) + step "
        f"{step_ms:.2f} ms "
        f"per batch of {B} x {T_mel} frames from int16 audio")
    model.eval()
    with torch.inference_mode():
        out = model.reconstruct(batch, sigma=0.0)
    torch.cuda.synchronize()
    mel, dur = out["mel"], out["durations"]
    log(f"[featurize] reconstruct at sigma 0: mel {tuple(mel.shape)}, "
        f"|mel| max {mel.abs().max().item():.2f}, MAS durations per item "
        f"{dur.sum(1).tolist()}")
    if not (mel.shape == batch["mel"].shape and torch.isfinite(mel).all()
            and torch.equal(dur.sum(1), batch["output_lengths"])):
        fail("reconstruct gave a wrong shape, non-finite values or "
             "durations that do not cover the frames")
    return launches


# the fit phase: the shipped 7-language recipe through the training CLI
RECIPE = ("configs/radmmm_model.yaml", "configs/radmmm_attributes.yaml",
          "configs/radmmm_opensource_data_phonemizerless.yaml",
          "configs/radmmm_train.yaml")
RECIPE_CORPORA = ("LJS", "BerndUngerer", "TUX", "Karen", "NadineEckert",
                  "IIIT-HYD", "ED")
# (corpus, language, train filelist, validation filelist) of the synthetic
# corpus: the shipped phonemized filelists of two of the recipe's corpora
FIT_SOURCES = (
    ("SYN_LJS", "en_US",
     "datasets/opensource/LJSpeech/"
     "ljs_audiopath_text_sid_emotion_duration_train_filelist_phonemized.txt",
     "datasets/opensource/LJSpeech/"
     "ljs_audiopath_text_sid_emotion_duration_val_filelist_phonemized.txt"),
    ("SYN_TUX", "es_ES",
     "datasets/opensource/MAILABS/es_ES/male/tux/"
     "tux_audiopath_text_sid_emotion_duration_train_filelist_filtered_"
     "phonemized.txt",
     "datasets/opensource/MAILABS/es_ES/male/tux/"
     "tux_audiopath_text_sid_emotion_duration_val_filelist_phonemized.txt"))
FIT_TRAIN, FIT_VAL, FIT_MAX_S = 12, 4, 6.0      # lines per corpus, seconds
FIT_SR = 16000
FIT_STEPS, FIT_RESUME_STEPS = 6, 8
# the launches of one training step by phase: MAS (K3) runs once
# binarization is on (from binarization_start_iter, 3 in the overlay)
FIT_BINARIZE_FROM = 3
# the radtts_fit phase: tracked stack (2), the LJSpeech RADTTS decoder with
# its four attribute predictors (the duration one an LSTMConvDAP), through
# the training CLI on a synthetic 22,050 Hz corpus in place of its one
# corpus, LJS, from the shipped phonemized LJSpeech filelists (its G2P
# dictionary, assets/en_US_word_ipa_map.txt, is not in the repository);
# 24 training lines, so an epoch is 3 batches of 8 as in the fit phase
RADTTS_STACK = ("configs/radtts_model.yaml", "configs/radtts_f0model.yaml",
                "configs/radtts_durationmodel.yaml",
                "configs/radtts_energymodel.yaml",
                "configs/radtts_vpredmodel.yaml",
                "configs/ljs_22khz_data.yaml", "configs/radmmm_train.yaml")
RADTTS_SOURCES = (("LJS",) + FIT_SOURCES[0][1:],)
RADTTS_TRAIN, RADTTS_SR = 24, 22050


def _voiced_wav(n: int, f0: float, rng, sr: int = FIT_SR) -> np.ndarray:
    """n samples of int16 voiced audio at ``sr``: a three-harmonic tone
    with 5 Hz vibrato, an unvoiced noise burst after every 0.9 s of
    tone."""
    t = np.arange(n) / sr
    phase = 2 * np.pi * f0 * t + f0 * 0.03 / 5.0 * np.sin(2 * np.pi * 5 * t)
    x = (0.4 * np.sin(phase) + 0.25 * np.sin(2 * phase)
         + 0.12 * np.sin(3 * phase))
    burst = (t % 1.0) >= 0.9
    x[burst] = 0.05 * rng.standard_normal(int(burst.sum()))
    return np.clip(np.rint(x * 32767 * 0.8), -32768, 32767).astype(np.int16)


def fit_corpus(root: str, seed: int, n_train: int = FIT_TRAIN,
               sources=FIT_SOURCES, sr: int = FIT_SR) -> dict:
    """The synthetic corpus under ``root``: for each of ``sources`` the
    first ``n_train`` / FIT_VAL lines of at most FIT_MAX_S seconds, their
    text, speaker and emotion kept, with voiced int16 audio of the line's
    duration at ``sr``. Returns {split: {corpus: dataset dict}}."""
    import os
    from scipy.io import wavfile
    rng = np.random.default_rng(seed)
    out = {"train": {}, "val": {}}
    rate = f"{sr // 1000}khz"
    for c, (name, lang, train_list, val_list) in enumerate(sources):
        for split, path, n in (("train", train_list, n_train),
                               ("val", val_list, FIT_VAL)):
            lines = []
            with open(path, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip("\n").split("|")
                    if len(parts) >= 5 and float(parts[4]) <= FIT_MAX_S:
                        lines.append(parts)
                    if len(lines) == n:
                        break
            base = os.path.join(root, name)
            for i, parts in enumerate(lines):
                wav = os.path.join(base, rate, parts[0])
                os.makedirs(os.path.dirname(wav), exist_ok=True)
                f0 = 100.0 + 25.0 * c + 7.0 * i
                wavfile.write(wav, sr, _voiced_wav(
                    int(float(parts[4]) * sr), f0, rng, sr))
            filelist = os.path.join(root, f"{name}_{split}.txt")
            with open(filelist, "w", encoding="utf-8") as f:
                f.write("\n".join("|".join(p) for p in lines) + "\n")
            out[split][name] = {
                "basedir": base, "sampling_rate": rate,
                "filelist_basedir": "", "filelist": filelist,
                "language": lang, "phonemized": True}
    return out


def _data_overlay(root: str, corpus: dict, data_config: str = RECIPE[2],
                  corpora=RECIPE_CORPORA) -> dict:
    """The data section of an overlay over the recipe (or over the data
    config ``data_config`` with its ``corpora``): its corpora replaced by
    the synthetic ones and, where its phonemizer dictionaries are not in
    the checkout, empty ones (every line and prompt is phonemized
    already)."""
    import os
    import yaml
    with open(data_config) as f:
        g2p = yaml.safe_load(f)["data"]["phonemizer_cfg"]
    missing = {lang: p for lang, p in g2p.items() if not os.path.exists(p)}
    for lang in missing:
        missing[lang] = os.path.join(root, f"{lang}_empty.txt")
        open(missing[lang], "w").close()
    return {"training_files": {**dict.fromkeys(corpora), **corpus["train"]},
            "validation_files": {**dict.fromkeys(corpora), **corpus["val"]},
            **({"phonemizer_cfg": {**g2p, **missing}} if missing else {})}


def _write_overlay(root: str, name: str, overlay: dict) -> str:
    """``overlay`` as a JSON file (JSON is YAML) under ``root``."""
    import os
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(overlay, f)
    return path


def fit_overlay(root: str, corpus: dict, vocoder_run: str = None,
                data: dict = None) -> str:
    """The overlay over the recipe (or over stack (2), given its ``data``
    section): the synthetic corpora, the output directory, 6 steps with
    validation and checkpoints every 3, the phase switches at 3
    (binarization) and 4 (KL), a log line every step, two checkpoints kept
    and, given ``vocoder_run``, that ``vocoder-fit`` run directory as the
    vocoder of validation and predict. No width or depth changes."""
    import os
    model = {"output_directory": os.path.join(root, "run"),
             "iters_per_checkpoint": 3, "binarization_start_iter": 3,
             "decoder_loss": {"init_args": {"kl_loss_start_iter": 4}}}
    if vocoder_run:
        model["vocoder_checkpoint_path"] = vocoder_run
    return _write_overlay(root, "overlay.yaml", {
        "model": model,
        "trainer": {"max_steps": FIT_STEPS, "val_check_interval": 3,
                    "log_interval": 1, "max_to_keep": 2},
        "data": data or _data_overlay(root, corpus)})


class _Tee(io.TextIOBase):
    """Standard output that is also kept, to read what a run printed."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _run_cli(argv, tag: str, phase: str = "fit"):
    """``radmmm_torch.training.cli.main(argv)`` in this process -> (its
    data module, its trainer, what it printed, seconds)."""
    from radmmm_torch.training import cli
    log(f"[{phase}] python -m radmmm_torch.training.cli {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        dm, trainer = cli.main(argv)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    log(f"[{phase}] {tag} in {s:.2f} s")
    return dm, trainer, "".join(tee.text), s


@contextlib.contextmanager
def _counted(target, name, tally: list, seconds: list = None):
    """Record the kernels' launches of every call of ``target.name`` (a
    method of a fit, whose loaders featurize: ``_counters(loaders=True)``)
    into ``tally``, one dict per call, and, given ``seconds``, each call's
    seconds, the card synchronised at its end."""
    orig = getattr(target, name)

    def wrapper(*a, **kw):
        from radmmm_torch.utils.graphs import synchronize
        before, t0 = _counters(loaders=True), time.perf_counter()
        out = orig(*a, **kw)
        if seconds is not None:
            # a loader's thread may be capturing its featurize graph
            synchronize()
            seconds.append(time.perf_counter() - t0)
        after = _counters(loaders=True)
        tally.append({k: after[k] - before[k] for k in after})
        return out

    setattr(target, name, wrapper)
    try:
        yield
    finally:
        setattr(target, name, orig)


def _metrics_rows(run_dir: str) -> list:
    import os
    with open(os.path.join(run_dir, "tb", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_vocoder(trainer, what: str, vocoder_run, tag: str = "fit"
                   ) -> None:
    """With a vocoder run configured, ``trainer`` vocoded with its HiFi-GAN
    and Denoiser, not Griffin-Lim."""
    from radmmm_torch.vocoder.utils import GriffinLimVocoder
    if vocoder_run is None:
        return
    voc_fn, denoiser = getattr(trainer, "_vocoder", (None, None))
    if voc_fn is None or isinstance(voc_fn, GriffinLimVocoder) \
            or denoiser is None:
        fail(f"{what} did not vocode with the HiFi-GAN of {vocoder_run} "
             "and its Denoiser")
    log(f"[{tag}] {what} vocoded with the vocoder-fit HiFi-GAN and its "
        "Denoiser")


def recipe_overlay(root: str, seed: int, vocoder_run: str = None) -> str:
    """The fit phase's overlay over the recipe, its corpus written under
    ``root``."""
    return fit_overlay(root, fit_corpus(root, seed), vocoder_run)


def radtts_overlay(root: str, seed: int) -> str:
    """The radtts_fit phase's overlay over stack (2), its corpus written
    under ``root``."""
    corpus = fit_corpus(root, seed, RADTTS_TRAIN, RADTTS_SOURCES, RADTTS_SR)
    return fit_overlay(root, corpus, data=_data_overlay(
        root, corpus, RADTTS_STACK[5], ("LJS",)))


def recipe_prompts(prompts: list, trainset) -> list:
    """The recipe's prompts whose speaker the synthetic corpus has."""
    return [p for p in prompts if p["spk_id"] in trainset.speaker_ids]


def radtts_prompts(prompts: list, trainset) -> list:
    """The prompts with every speaker set to the corpus's one (stack (2)
    names its speaker without the emotion)."""
    spk = sorted(trainset.speaker_ids)[0]
    return [dict(p, **{k: spk for k in p if k.endswith("spk_id")})
            for p in prompts]


@tf32_off()
def phase_fit(seed: int, tag: str, configs: tuple, sr: int, overlay,
              pick_prompts, vocoder_run: str = None) -> dict:
    """A config stack (``configs``, audio at ``sr``) at full width through
    the training CLI: fit to 6 steps, a resume to 8, predict and export,
    with ``vocoder_run`` (a ``vocoder-fit`` run directory) as the vocoder
    of validation and predict, and an upstream-format HiFi-GAN v1 file
    baked into the export. ``overlay(root)`` writes the corpus and the
    overlay under ``root`` and returns the overlay's path;
    ``pick_prompts(prompts, trainset)`` fits the recipe's prompts of the
    corpus's languages to its speakers. ``tag`` prefixes the log lines.
    Returns the kernels' launches on the training steps, validation and
    predict."""
    import os
    from radmmm_torch.data.loader import DataLoader
    from radmmm_torch.serving import load_tts
    from radmmm_torch.training.loop import Trainer
    from radmmm_torch.utils.device import card_line
    card = card_line()
    root = tempfile.mkdtemp(prefix="radmmm_fit_")
    try:
        run_dir = os.path.join(root, "run")
        base = [a for c in configs + (overlay(root),) for a in ("-c", c)]
        steps, vals, preds = [], [], []
        torch.cuda.reset_peak_memory_stats()
        # the main path: counts from zero, fit, counts read after
        _zero_counters()
        with _counted(Trainer, "_run_step", steps), \
                _counted(Trainer, "validate", vals):
            dm, tr, out, fit_s = _run_cli(["fit"] + base, "fit to 6 steps",
                                          tag)
        _check_vocoder(tr, "validation", vocoder_run, tag)
        # steps 2 to FIT_STEPS - 1 (the first warms up; the last ends in
        # the final save): start to next start, less the validation and
        # saves after the step
        starts, pauses = tr.stats["step_starts"], tr.stats["pause_s"]
        walls = [starts[i + 1] - starts[i] - pauses.get(i + 1, 0.0)
                 for i in range(1, FIT_STEPS - 1)]
        fit_stats = dict(tr.stats)
        n_params = sum(p.numel() for p in tr.model.parameters())
        rows = _metrics_rows(run_dir)
        log(f"[{tag}] the model: {n_params / 1e6:.1f} M parameters, "
            f"{len(dm.trainset)} training and {len(dm.valset)} validation "
            f"utterances, batch {dm.batch_size}, megastep_k "
            f"{tr.cfg.megastep_k}")
        with _counted(Trainer, "_run_step", steps):
            dm2, tr2, out2, resume_s = _run_cli(
                ["fit"] + base + [
                    f"--trainer.max_steps={FIT_RESUME_STEPS}",
                    f"--trainer.profile_dir={root}/profile",
                    f"--trainer.profile_start_step={FIT_STEPS}",
                    f"--trainer.profile_n_steps="
                    f"{FIT_RESUME_STEPS - FIT_STEPS}"],
                f"resume to step {FIT_RESUME_STEPS}, profiled", tag)
        launches = _counters(loaders=True)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        counted = {k: sum(d[k] for d in steps + vals) for k in launches}
        if counted != launches:
            fail(f"kernels launched outside the training steps and "
                 f"validations of fit: {launches} against {counted}")
        if f"resumed from step {FIT_STEPS}" not in out2:
            fail(f"the second fit did not resume from step {FIT_STEPS}")
        feat2, keys = dm2.featurizer, tr2.stats["noise_keys"]
        want_keys = [feat2.noise_key_for_step(s)
                     for s in range(FIT_STEPS, FIT_RESUME_STEPS)]
        log(f"[{tag}] the resumed run's noise base {feat2._noise_base}, its "
            f"steps' noise keys: {keys}")
        if keys != want_keys or feat2._noise_base != FIT_STEPS:
            fail("the resumed steps did not use the noise base "
                 f"{FIT_STEPS} and their steps' keys")
        rows += _metrics_rows(run_dir)[len(rows):]
        train_rows = [r for r in rows if "train/loss" in r]
        bad = [r for r in rows for k, v in r.items() if k != "step"
               and "loss" in k and not math.isfinite(v)]
        log(f"[{tag}] {len(rows)} metrics.jsonl rows; train loss by step: "
            + ", ".join(f"{r['step']}: {r['train/loss']:.4f}"
                        for r in train_rows))
        log(f"[{tag}] validation rows: " + "; ".join(
            f"step {r['step']}: " + ", ".join(
                f"{k[4:]} {v:.4f}" for k, v in r.items() if k != "step")
            for r in rows if any(k.startswith("val/") for k in r)))
        if bad or [r["step"] for r in train_rows] != list(
                range(1, FIT_RESUME_STEPS + 1)):
            fail(f"non-finite losses or missing steps in metrics.jsonl: "
                 f"{bad or [r['step'] for r in train_rows]}")
        if not all("train/duration_loss" in r for r in train_rows):
            fail("a training step logged no duration loss")
        for i, got in enumerate(steps):
            want = dict(FIT_STEP)
            if i < FIT_BINARIZE_FROM:
                want["mas_width1"] = 0
            if got != want:
                fail(f"training step {i + 1} launched {got}, expected "
                     f"{want}")
        log(f"[{tag}] kernel launches on each of the {len(steps)} training "
            f"steps as expected: {FIT_STEP} (mas_width1 0 before step "
            f"{FIT_BINARIZE_FROM + 1}, binarization off); on each of "
            f"{len(vals)} validations: {vals[0]}")
        ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpt")))
        log(f"[{tag}] checkpoints kept: {ckpts}")
        if ckpts != ["6", "8"]:
            fail(f"expected checkpoints 6 and 8 (max_to_keep 2), {ckpts}")

        # predict: the recipe's prompts of the synthetic corpus's
        # languages, fitted to its speakers
        with open("model_inputs/resynthesis_prompts.json") as f:
            prompts = pick_prompts([p for p in json.load(f)
                                    if p["language"] in
                                    dm.trainset.accent_ids], dm.trainset)
        ppath = os.path.join(root, "prompts.json")
        with open(ppath, "w") as f:
            json.dump(prompts, f)
        _zero_counters()
        with _counted(Trainer, "predict", preds):
            _, tr3, _, predict_s = _run_cli(
                ["predict"] + base + [f"--data.inference_transcript={ppath}"],
                f"predict of {len(prompts)} prompts", tag)
        _check_vocoder(tr3, "predict", vocoder_run, tag)
        from scipy.io import wavfile
        pred_dir = os.path.join(run_dir, "predictions")
        wavs = sorted(os.listdir(pred_dir))
        hop, t_max = tr3.cfg.hop_length, tr3.cfg.max_infer_frames
        sizes = []
        for name, frames in zip(wavs, tr3.predicted_frames):
            rate, wav = wavfile.read(os.path.join(pred_dir, name))
            sizes.append(wav.size)
            if not (rate == sr and wav.size == min(frames, t_max - 1) * hop
                    and np.isfinite(wav).all()):
                fail(f"prediction {name}: {wav.size} samples at {rate} Hz, "
                     f"expected {frames} frames of {hop} at {sr} Hz")
        if len(wavs) != len(prompts):
            fail(f"{len(wavs)} prediction wavs for {len(prompts)} prompts")
        peaks = [int(np.abs(wavfile.read(os.path.join(pred_dir, n))[1])
                     .max()) for n in wavs]
        log(f"[{tag}] predict wrote {len(wavs)} wavs of {sizes} samples "
            f"({tr3.predicted_frames} frames, int16 peaks {peaks}); "
            f"launches {preds[0]}")

        # the export with an upstream-format HiFi-GAN v1 g_* file baked
        # in (as in the JAX package, a vocoder-fit run dir cannot be)
        g_path, g_cfg = write_g_file(root, seed, sr)
        epath = os.path.join(root, "tts_export.bin")
        _, _, _, export_s = _run_cli(
            ["export"] + base + [f"--export.path={epath}",
                                 f"--model.vocoder_checkpoint_path={g_path}",
                                 f"--model.vocoder_config_path={g_cfg}"],
            "export with the HiFi-GAN baked in", tag)
        tts = load_tts(epath, device="cuda")
        text = np.full((1, 24), 5, np.int32)
        audio, lens = tts(text, np.asarray([24], np.int32),
                          np.asarray([0], np.int32), np.asarray([0], np.int32),
                          np.asarray([5.0], np.float32),
                          np.asarray([0.3], np.float32), 0)
        log(f"[{tag}] the export ({os.path.getsize(epath) / 1e6:.1f} MB) "
            f"loaded with serving.load_tts: one request, "
            f"{tts.output_kind} {tuple(audio.shape)} {audio.dtype} on "
            f"{audio.device}, {int(lens[0])} frames, peak "
            f"{int(audio.abs().max())}")
        if (tts.output_kind != "audio" or audio.dtype != torch.int16
                or audio.device.type != "cuda" or int(lens[0]) <= 0
                or audio.shape[1] < int(lens[0]) * HOP):
            fail("the export with the vocoder baked in did not answer with "
                 "int16 audio on the card")

        # featurize alone, on a batch the loader makes
        feat = dm.featurizer
        host = next(iter(DataLoader(dm.trainset, dm.batch_size,
                                    featurizer=None, num_threads=1)))
        raw = {k: torch.from_numpy(v).cuda()
               for k, v in feat.raw_arrays(host).items()}
        feat_ms = cuda_ms(lambda: feat.featurize_raw(raw, 0), 3)
        s = fit_stats
        step_ms = 1e3 * sum(walls) / len(walls)
        log(f"[{tag}] ({card}) fit: steps 2-{FIT_STEPS - 1} "
            f"{', '.join(f'{1e3 * w:.1f}' for w in walls)} ms, mean "
            f"{step_ms:.2f} ms a step (B={dm.batch_size}, featurize, "
            f"loader and logging included, validation and saves not); all "
            f"{s['steps']} steps {1e3 * s['train_s'] / s['steps']:.2f} ms a "
            f"step, of it waiting on the loader "
            f"{100 * s['loader_wait_s'] / s['train_s']:.1f}%; the first "
            f"batch, with the batches loaded beside it, {s['first_batch_s']:.2f}"
            f" s; featurize "
            f"{feat_ms:.2f} ms a batch ({tuple(host['audio'].shape)} "
            f"samples); validation {s['val_s']:.2f} s for {len(vals)}; "
            f"checkpoint save {s['ckpt_save_s'] / s['ckpt_saves']:.2f} s a "
            f"save, {s['ckpt_bytes'] / 1e9:.3f}"
            f" GB each; restore {tr2.stats['restore_s']:.2f} s; peak device "
            f"memory of fit and resume {peak_gib:.2f} GiB; predict "
            f"{predict_s:.2f} s; export {export_s:.2f} s; fit wall "
            f"{fit_s:.2f} s, resume {resume_s:.2f} s")
        busy, wall = (tr2.stats.get("profile_busy_s"),
                      tr2.stats.get("profile_wall_s"))
        if busy:
            n = FIT_RESUME_STEPS - FIT_STEPS
            log(f"[{tag}] ({card}) profiled steps {FIT_STEPS + 1}-"
                f"{FIT_RESUME_STEPS}: wall {wall * 1e3:.1f} "
                f"ms, device busy {busy * 1e3:.1f} ms "
                f"({100 * busy / wall:.1f}% of the profiled wall; "
                f"{1e3 * busy / n:.1f} ms a step is "
                f"{100 * busy / n / (step_ms / 1e3):.1f}% of the unprofiled "
                f"{step_ms:.2f} ms a step)")
            log(f"[{tag}] the profiled steps' top kernels, ms summed: "
                + "; ".join(f"{name[:60]} {ms:.2f}" for name, ms in
                            tr2.stats.get("profile_top_ms", [])))
        else:
            log(f"[{tag}] the profiler saw no device time: busy share not "
                "measured")
        return {"fit": launches, "steps": len(steps), "val": vals,
                "predict": preds[0]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the bf16 phase: model.conv_precision bf16 (ops/conv.set_conv_precision)
# on the serving and training paths. The flagship step's loss terms in bf16
# against f32 from the same weights and batch, relative (read on an H100:
# 2.3e-3 at worst, energy_loss); the short step card against CPU, both in
# bf16: the loss terms relative (read 3.1e-4), the gradients by Frobenius
# norm: the median leaf and the whole tree within BF16_GRAD_RTOL (read
# 1.8e-3 and 6.6e-3), every leaf within BF16_LEAF_RTOL (read 7.2e-2: the
# text encoder's convs and norms, near-cancelling sums through leaky-ReLU
# kinks, where one bf16 rounding apart moves them most, as
# tests/test_torch_precision.py reads for JAX's bf16 step against its f32
# one)
BF16_VS_F32_RTOL = 1e-2
BF16_PARITY_RTOL = 2e-3
BF16_GRAD_RTOL = 2e-2
BF16_LEAF_RTOL = 0.25
BF16_FIT_STEPS = 4


@contextlib.contextmanager
def conv_precision(mode: str):
    """The process-wide conv precision set to ``mode`` inside, f32 after."""
    from radmmm_torch.ops.conv import set_conv_precision
    set_conv_precision(mode)
    try:
        yield
    finally:
        set_conv_precision("f32")


def _bf16_routes(gen, dev) -> None:
    """The flow context's lane (H 528) on both routes of the bf16 kernels:
    the one their plan takes and the other (a 16-CTA cluster of 33 units a
    CTA, or the 66-CTA grid of 8), forward at B 1 (serving) and B 8
    (training, states saved) and backward at B 8, each against the bf16
    twin and timed in turns (plan, other, other, plan)."""
    from radmmm_torch.ops import lstm_kernel as lk
    _, L, H, T_serve, _ = PATH_SHAPES[3]
    T_train = TRAIN_SHAPES[3][3]
    for direction, B, T in (("fwd", 1, T_serve), ("fwd", TRAIN_B, T_train),
                            ("bwd", TRAIN_B, T_train)):
        lens = _lengths(T, B)
        mask = (torch.arange(T)[:, None] < lens[None, :]).float().to(dev)
        xp = torch.randn((L, T, B, 4 * H), generator=gen, device=dev)
        wh = (torch.rand((L, H, 4 * H), generator=gen, device=dev)
              * 2 - 1) / H ** 0.5
        rev = [False, True]
        save = B > 1
        if direction == "fwd":
            plan_fn, picked = lk.forward_plan, lk.card_forward_plan(
                L, B, H, True)
            run = functools.partial(lk._forward_kernel, xp, mask, wh, rev,
                                    save, bf16=True)
            want = lk.lstm_recurrence_reference(xp, mask, wh, rev, save=save,
                                                bf16=True)
        else:
            _, act, cs, _ = lk.lstm_recurrence_reference(
                xp, mask, wh, rev, save=True, bf16=True)
            dout = torch.randn((L, T, B, H), generator=gen, device=dev)
            plan_fn, picked = lk.backward_plan, lk.card_backward_plan(
                L, B, H, True)
            run = functools.partial(lk._backward_kernel, dout, act, cs, mask,
                                    wh, rev, bf16=True)
            want = lk.lstm_recurrence_backward_reference(
                dout, act, cs, mask, wh, rev, bf16=True)
        other = plan_fn(L, B, H, lk.card_limits(*lk._kernel(direction, True)),
                        bf16=True, route=("grid" if picked.route == "cluster"
                                          else "cluster"))
        want = want if isinstance(want, tuple) else (want,)
        errs, ms = {}, {}
        for plan in (picked, other):
            got = run(plan=plan)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            checks = [_rel_err_ok(g, w, BF16_KERNEL_ATOL, BF16_KERNEL_ATOL)
                      for g, w in zip(got, want)]
            errs[plan.route] = (max(e for e, _ in checks),
                                all(ok for _, ok in checks))
        for plan in (picked, other, other, picked):
            ms.setdefault(plan.route, []).append(
                cuda_ms(lambda: run(plan=plan), 20))
        log(f"[bf16] K4_bf16 {direction} flow_context L={L} H={H} T={T} "
            f"B={B}, in turns: "
            + "; ".join(
                f"{'the plan' if p is picked else 'the other route'}, "
                f"{p.route} of {p.n_cta} CTAs x {p.hb} units, ks {p.ks}, "
                f"{p.smem} bytes a CTA: max_abs_err {errs[p.route][0]:.3e}, "
                + ", ".join(f"{x:.4f}" for x in ms[p.route]) + " ms ("
                f"{min(ms[p.route]) * 1e3 / T:.2f} us/step)"
                for p in (picked, other)))
        if not all(ok for _, ok in errs.values()):
            fail(f"K4_bf16 {direction} disagrees with its twin on a route "
                 "of the flow context's lane")


def _bf16_against_f32(rows) -> None:
    """The bf16 kernels' time against the f32 kernels' in this call: the
    forward over the training step's four shapes and over a B=1 request's
    four, the backward over the step's four."""
    for what, kernel, path, B in (
            ("forward, the training step's four", "lstm_recurrence_bf16",
             "train", TRAIN_B),
            ("forward, a B=1 request's four", "lstm_recurrence_bf16",
             "serve", 1),
            ("backward, the training step's four",
             "lstm_recurrence_bwd_bf16", "train", TRAIN_B)):
        rs = [r for r in rows if r["kernel"] == kernel and r["path"] == path
              and r["B"] == B]
        bf, f32 = sum(r["ms"] for r in rs), sum(r["f32_ms"] for r in rs)
        log(f"[bf16] K4 {what}: bf16 {bf:.4f} ms, f32 {f32:.4f} ms "
            f"({bf / f32:.3f} of it; "
            + ", ".join(f"{r['shape']} {r['ms']:.4f} against "
                        f"{r['f32_ms']:.4f}" for r in rs) + ")")


def _bf16_projection() -> None:
    """The LSTM input projections at the training shapes (the ganged frame
    DAPs and the flow context), f32 against bf16 mode, and which bf16
    product the installed PyTorch offers."""
    from radmmm_torch.ops.conv import matmul
    dev = torch.device("cuda")
    out_dtype = "dtype" in torch.ops.aten.mm.overloads()
    for name, P, n, c, g in (("frame_daps_ganged", 3, TRAIN_B * TRAIN_T_MEL,
                              256, 1024),
                             ("flow_context", 1, TRAIN_B * TRAIN_T_MEL // 2,
                              1060, 4224)):
        x = torch.randn((P, n, c), device=dev)
        w = torch.randn((P, c, g), device=dev)
        f32_ms = cuda_ms(lambda: torch.matmul(x, w), 20)
        with conv_precision("bf16"):
            got = matmul(x, w)
            bf_ms = cuda_ms(lambda: matmul(x, w), 20)
        want = torch.matmul(x.bfloat16().float(), w.bfloat16().float())
        err = ((got - want).abs().max() / want.abs().max()).item()
        log(f"[bf16] LSTM projection {name} ({P}, {n}, {c}) x ({c}, {g}): "
            f"f32 {f32_ms:.4f} ms, bf16 mode {bf_ms:.4f} ms via "
            + ("torch.bmm(bf16, bf16, out_dtype=float32)" if out_dtype else
               "the f32 product of bf16-rounded operands")
            + f"; against the f32 product of the rounded operands "
              f"{err:.2e} of its largest magnitude")
        if not err <= 1e-5:
            fail(f"bf16: the {name} projection is not the product of the "
                 "rounded operands")


def _bf16_vs_f32_step(seed: int) -> None:
    """One flagship step (dropout off) from the same weights and batch in
    f32 and in bf16: the loss terms side by side."""
    from radmmm_torch.models.tts import TTSModel
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_step,
                                            make_whitening_init)
    batch = train_batch(seed, TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL,
                        torch.device("cuda"))
    torch.manual_seed(seed)
    base = TTSModel(no_dropout_config())
    _nudge_couplings(base)
    res = {}
    for mode in ("f32", "bf16"):
        m = copy.deepcopy(base)
        state = create_train_state(m, device="cuda")
        make_whitening_init(m)(state, batch)
        with conv_precision(mode):
            step = make_train_step(m, _loss_config(), binarize=True,
                                   kl_on=True)
            _, met = step(state, batch, torch.Generator(device="cuda"))
        res[mode] = {k: v.item() for k, v in met.items()}
        del m, state
    worst = 0.0
    for k, want in res["f32"].items():
        got = res["bf16"][k]
        rel = abs(got - want) / max(abs(want), 1e-6)
        worst = max(worst, rel)
        log(f"[bf16]   {k}: bf16 {got:.6f}, f32 {want:.6f}, relative "
            f"{rel:.3e}")
        if not math.isfinite(got):
            fail(f"bf16 step: {k} is not finite")
    log(f"[bf16] the flagship step's loss terms, bf16 against f32 from the "
        f"same weights and batch: worst relative {worst:.3e} (bound "
        f"{BF16_VS_F32_RTOL:g})")
    if not worst <= BF16_VS_F32_RTOL:
        fail("bf16 step: a loss term strays from f32's")


def _bf16_card_vs_cpu(seed: int) -> None:
    """phase_train_parity's short step in bf16 on the card and on the CPU
    (the bf16 twins, PyTorch's bf16 convolutions on the CPU): loss terms,
    then gradients by Frobenius norm."""
    from radmmm_torch.models.tts import TTSModel
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_step,
                                            make_whitening_init)
    torch.manual_seed(seed + 2)
    cpu_model = TTSModel(no_dropout_config())
    _nudge_couplings(cpu_model)
    models = {"cuda": copy.deepcopy(cpu_model), "cpu": cpu_model}
    res = {}
    with conv_precision("bf16"):
        for where, m in models.items():
            batch = train_batch(seed + 3, 2, 12, 64, where,
                                text_lens=[12, 9], mel_lens=[64, 50])
            state = create_train_state(m, device=where)
            make_whitening_init(m)(state, batch)
            step = make_train_step(m, _loss_config(), binarize=True,
                                   kl_on=True)
            state, met = step(state, batch, torch.Generator(device=where))
            res[where] = {k: v.item() for k, v in met.items()}
    worst = max(abs(res["cuda"][k] - w) / (1e-5 + abs(w))
                for k, w in res["cpu"].items())
    bad = [k for k, v in res["cuda"].items() if not math.isfinite(v)]
    log(f"[bf16] short step card against CPU, both bf16: loss terms worst "
        f"relative {worst:.3e} (bound {BF16_PARITY_RTOL:g}); "
        + ", ".join(f"{k} {res['cuda'][k]:.5f}/{res['cpu'][k]:.5f}"
                    for k in ("loss", "loss_mel", "duration_loss",
                              "grad_norm") if k in res["cpu"]))
    if bad or not worst <= BF16_PARITY_RTOL:
        fail(f"bf16: card and CPU disagree on the short step's losses "
             f"{bad}")
    errs = leaf_grad_errors(models["cuda"], models["cpu"], frobenius=True)
    diff2 = norm2 = 0.0
    for (n, p), q in zip(models["cuda"].named_parameters(),
                         models["cpu"].parameters()):
        if q.grad is not None and p.grad is not None:
            diff2 += (p.grad.cpu() - q.grad).norm().item() ** 2
            norm2 += q.grad.norm().item() ** 2
    tree = (diff2 / max(norm2, 1e-30)) ** 0.5
    median = sorted(e[0] for e in errs)[len(errs) // 2]
    log(f"[bf16] gradients of {len(errs)} parameters by Frobenius norm, "
        f"card against CPU: the tree {tree:.3e}, the median leaf "
        f"{median:.3e} (bound {BF16_GRAD_RTOL:g}); worst leaves (bound "
        f"{BF16_LEAF_RTOL:g}): " + ", ".join(
            f"{n} {e:.2e}" for e, n, _ in errs[:5]))
    if not (tree <= BF16_GRAD_RTOL and median <= BF16_GRAD_RTOL
            and errs[0][0] <= BF16_LEAF_RTOL):
        fail("bf16: card and CPU gradients disagree")


def _bf16_fit(seed: int) -> dict:
    """The recipe through ``training/cli.py fit`` with
    ``model.conv_precision: bf16`` for BF16_FIT_STEPS steps with a
    validation at the last, then ``predict``: each step's launches
    (PER_STEP_BF16), finite losses, the predictions' wavs. Returns the
    launches of the steps, the validation and predict."""
    import os
    from radmmm_torch.ops.conv import get_conv_precision
    from radmmm_torch.training.loop import Trainer
    root = tempfile.mkdtemp(prefix="radmmm_bf16_fit_")
    try:
        base = [a for c in RECIPE + (recipe_overlay(root, seed),)
                for a in ("-c", c)]
        base += ["--model.conv_precision=bf16",
                 f"--trainer.max_steps={BF16_FIT_STEPS}",
                 f"--trainer.val_check_interval={BF16_FIT_STEPS}",
                 "--model.iters_per_checkpoint=100"]
        steps, vals, preds = [], [], []
        _zero_counters()
        try:
            with _counted(Trainer, "_run_step", steps), \
                    _counted(Trainer, "validate", vals):
                dm, tr, _, fit_s = _run_cli(
                    ["fit"] + base, f"fit to {BF16_FIT_STEPS} steps in bf16",
                    "bf16")
            if get_conv_precision() != "bf16":
                fail("bf16 fit: the trainer did not set the precision")
            with open("model_inputs/resynthesis_prompts.json") as f:
                prompts = recipe_prompts([p for p in json.load(f)
                                          if p["language"] in
                                          dm.trainset.accent_ids],
                                         dm.trainset)
            ppath = os.path.join(root, "prompts.json")
            with open(ppath, "w") as f:
                json.dump(prompts, f)
            with _counted(Trainer, "predict", preds):
                _, tr3, _, predict_s = _run_cli(
                    ["predict"] + base
                    + [f"--data.inference_transcript={ppath}"],
                    f"predict of {len(prompts)} prompts in bf16", "bf16")
        finally:
            from radmmm_torch.ops.conv import set_conv_precision
            set_conv_precision("f32")
        launches = _counters(loaders=True)
        rows = _metrics_rows(os.path.join(root, "run"))
        train_rows = [r for r in rows if "train/loss" in r]
        bad = [r for r in rows for k, v in r.items()
               if k != "step" and "loss" in k and not math.isfinite(v)]
        if bad or len(train_rows) != BF16_FIT_STEPS:
            fail(f"bf16 fit: non-finite losses or missing steps {bad}")
        for i, got in enumerate(steps):
            want = dict(FIT_STEP_BF16)
            if i < FIT_BINARIZE_FROM:
                want["mas_width1"] = 0
            if got != want:
                fail(f"bf16 fit: step {i + 1} launched {got}, expected "
                     f"{want}")
        if not vals or any(v["lstm_recurrence"] or v["lstm_recurrence_bwd"]
                           for v in vals + preds):
            fail("bf16 fit: validation or predict ran the f32 K4")
        pred_dir = os.path.join(root, "run", "predictions")
        wavs = sorted(os.listdir(pred_dir))
        if len(wavs) != len(prompts) or not prompts:
            fail(f"bf16 predict: {len(wavs)} wavs for {len(prompts)} "
                 "prompts")
        walls = tr.stats["step_starts"]
        log(f"[bf16] fit in bf16: train loss by step "
            + ", ".join(f"{r['step']}: {r['train/loss']:.4f}"
                        for r in train_rows)
            + f"; steps 2-{BF16_FIT_STEPS}: " + ", ".join(
                f"{1e3 * (b - a):.1f}" for a, b in zip(walls[1:], walls[2:]))
            + f" ms start to start; fit {fit_s:.1f} s, predict "
              f"{predict_s:.1f} s ({len(wavs)} wavs); launches on each "
              f"step {steps[-1]}, validation {vals[0]}, predict {preds[0]}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_bf16(seed: int, train_ms) -> tuple:
    """``model.conv_precision: bf16`` on the card: (a) the bf16 variants
    of K4 and its backward against their bf16 twins at the serving and
    training shapes, each beside the f32 kernel at its shape and cuDNN's
    LSTM in bf16; their sums against the f32 kernels'; the H 528 lane on
    both routes; the LSTM projections;
    (b) the flagship step in bf16 (3 warm steps, launches, peak memory, a
    profiled step) beside the train phase's f32 ms, its loss terms against
    f32's from the same weights, and the short step card against CPU in
    bf16; (c) ``fit`` and ``predict`` of the recipe in bf16; (a)-(c) with
    TF32 off, as the kernels, train and fit phases run; (d) the daemon's
    four requests in bf16 with PyTorch's TF32 defaults, as the serve phase
    runs (the vocoder's f32 convolutions in TF32). Returns (kernel rows,
    the launches of the main paths: the training steps, fit, serving)."""
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    rows = []
    with tf32_off():
        for name, L, H, T, cin in PATH_SHAPES:
            for B in (1, 8):
                rows.append(_lstm_rows(gen, dev, name, L, H, T, cin, B,
                                       train=False, bf16=True)[0])
        for name, L, H, T, cin in TRAIN_SHAPES:
            rows.extend(_lstm_rows(gen, dev, name, L, H, T, cin, TRAIN_B,
                                   train=True, bf16=True))
        _bf16_against_f32(rows)
        _bf16_routes(gen, dev)
        _bf16_projection()
        log(f"[bf16] kernels in {time.perf_counter() - t0:.1f} s")

        batch = train_batch(seed, TRAIN_B, TRAIN_T_TEXT, TRAIN_T_MEL, dev)
        with conv_precision("bf16"):
            _, step, state, g, train_launches, ms = _flagship_training(
                seed, batch, "bf16", PER_STEP_BF16)
            profile(lambda: step(state, batch, g),
                    f"one bf16 training step (B={TRAIN_B}, "
                    f"T_mel={TRAIN_T_MEL}, traced)", top=15)
        log(f"[bf16] the flagship step: bf16 {ms:.2f} ms, f32 (the train "
            "phase, this call) "
            + (f"{train_ms:.2f} ms" if train_ms else "not run"))
        del step, state, batch
        torch.cuda.empty_cache()
        _bf16_vs_f32_step(seed)
        _bf16_card_vs_cpu(seed)
        torch.cuda.empty_cache()
        fit_launches = _bf16_fit(seed)

    model, vocoder = build_models(seed)
    model.cache_inverses()
    model_gpu = copy.deepcopy(model).cuda().cache_inverses()
    with conv_precision("bf16"):
        n = phase_serve(seed, model, vocoder, model_gpu, "bf16 serve",
                        "lstm_recurrence_bf16")
    serve_launches = dict(dict.fromkeys(PER_STEP, 0), lstm_recurrence_bf16=n)
    del model, vocoder, model_gpu
    torch.cuda.empty_cache()
    log(f"[bf16] phase in {time.perf_counter() - t0:.1f} s")
    return rows, {"train": train_launches, "fit": fit_launches,
                  "serve": serve_launches}

# the caches phase: tracked stack (2) on a synthetic 22,050 Hz corpus like
# the radtts_fit phase's, its audio and F0 caches built on the card through
# radmmm_torch.scripts.build_audio_cache and build_f0_cache, then fit to
# CACHE_STEPS without the caches and with them, steps CACHE_PROFILE_FROM + 1
# to CACHE_STEPS profiled in each; the host MAS (native.mas_batch_cpu)
# against K3 at the training batch's shape and on a ragged batch
CACHE_STEPS, CACHE_PROFILE_FROM = 6, 4
# the cache-fed batch against the compute path, as tests/test_f0_cache.py
# holds the JAX package's: mel and energy within CACHE_FEAT_ATOL; F0 (log
# F0) within CACHE_F0_ATOL on more than CACHE_AGREE of each item's valid
# frames (the cache ran pYIN over another padded length, so a Viterbi tie
# at the tail may go the other way), voicing equal on more than
# CACHE_AGREE of them
CACHE_FEAT_ATOL, CACHE_F0_ATOL, CACHE_AGREE = 1e-6, 5e-3, 0.9


def soft_attention(rng, B: int, T_mel: int, T_text: int) -> np.ndarray:
    """Plausible soft attention: a noisy diagonal, each row normalised
    over the text (tests/test_alignment.py's ``soft_attn``)."""
    a = rng.uniform(0.01, 1.0, (B, T_mel, T_text)).astype(np.float32)
    i = np.arange(T_mel)
    a[:, i, (i * T_text) // T_mel] += 3.0
    return a / a.sum(-1, keepdims=True)


def _caches_mas(seed: int) -> None:
    """``native.mas_batch_cpu`` against K3 on the card, bit for bit, at the
    training batch's (B, T_mel, T_text) with full lengths and on a ragged
    batch (text_len 1 and mel_len 1 among its items)."""
    import os
    from radmmm_torch import native
    from radmmm_torch.ops.alignment import mas_width1
    rng = np.random.default_rng(seed)
    B, T_mel, T_text = TRAIN_B, TRAIN_T_MEL, TRAIN_T_TEXT
    attn = soft_attention(rng, B, T_mel, T_text)
    ragged = (np.r_[1, T_text, rng.integers(2, T_text, B - 2)],
              np.r_[T_mel, 1, rng.integers(2, T_mel, B - 2)])
    for name, (tl, ml) in (("full", (np.full(B, T_text), np.full(B, T_mel))),
                           ("ragged", ragged)):
        tl, ml = tl.astype(np.int32), ml.astype(np.int32)
        t0 = time.perf_counter()
        host = native.mas_batch_cpu(attn, tl, ml)
        host_ms = 1e3 * (time.perf_counter() - t0)
        card = mas_width1(torch.from_numpy(attn).cuda(),
                          torch.from_numpy(tl).cuda(),
                          torch.from_numpy(ml).cuda()).cpu().numpy()
        diff = int((host != card).sum())
        log(f"[caches] native.mas_batch_cpu against K3 at ({B}, {T_mel}, "
            f"{T_text}), {name} (text lengths {tl.tolist()}, mel lengths "
            f"{ml.tolist()}): {diff} elements differ; the host's "
            f"{os.cpu_count()} threads {host_ms:.2f} ms")
        if diff:
            fail(f"native.mas_batch_cpu and K3 disagree on {diff} elements "
                 f"of the {name} batch")


def _caches_features(dm_plain, dm_cached, card: str) -> dict:
    """The first eight training items, from the wavs with pYIN and from
    the audio and F0 caches, featurized on the card and compared; the
    featurize ms of each batch."""
    from radmmm_torch.data.collate import collate_host
    n = min(8, len(dm_plain.trainset))
    host_p = collate_host([dm_plain.trainset[i] for i in range(n)])
    host_c = collate_host([dm_cached.trainset[i] for i in range(n)])
    if "cached_f0" not in host_c or "cached_f0" in host_p:
        fail("the cache-fed batch has no F0 tracks (or the plain one has)")
    if not np.array_equal(host_p["audio"], host_c["audio"]):
        fail("the audio cache's batch differs from the wavs'")
    b_p, b_c = dm_plain.featurizer(host_p), dm_cached.featurizer(host_c)
    errs = {k: float((b_c[k] - b_p[k]).abs().max())
            for k in ("mel", "energy_avg")}
    lens = b_p["output_lengths"].cpu().numpy()
    f0_p, f0_c = b_p["f0"].cpu().numpy(), b_c["f0"].cpu().numpy()
    v_p = b_p["voiced_mask"].cpu().numpy()
    v_c = b_c["voiced_mask"].cpu().numpy()
    f0_ok = [float(np.isclose(f0_c[i, :m], f0_p[i, :m],
                              atol=CACHE_F0_ATOL).mean())
             for i, m in enumerate(lens)]
    v_ok = [float((v_c[i, :m] == v_p[i, :m]).mean())
            for i, m in enumerate(lens)]
    pad = max(max(np.abs(f0_c[i, m:]).max(initial=0.0),
                  np.abs(v_c[i, m:]).max(initial=0.0))
              for i, m in enumerate(lens))
    log(f"[caches] the cache-fed batch ({n} items, {f0_p.shape[1]} frames) "
        f"against the compute path on the card: mel max |diff| "
        f"{errs['mel']:.3e}, energy {errs['energy_avg']:.3e} (bound "
        f"{CACHE_FEAT_ATOL}); share of each item's valid frames with F0 "
        f"within {CACHE_F0_ATOL}: {', '.join(f'{x:.3f}' for x in f0_ok)}; "
        f"voicing equal: {', '.join(f'{x:.3f}' for x in v_ok)} (bound > "
        f"{CACHE_AGREE}); padding max {pad}")
    if (max(errs.values()) > CACHE_FEAT_ATOL or min(f0_ok) <= CACHE_AGREE
            or min(v_ok) <= CACHE_AGREE or pad != 0):
        fail("the cache-fed batch disagrees with the compute path")
    raws = {}
    for tag, dm, host in (("without", dm_plain, host_p),
                          ("with", dm_cached, host_c)):
        feat = dm.featurizer
        raws[tag] = {k: torch.from_numpy(v).cuda()
                     for k, v in feat.raw_arrays(host).items()}
    ms = {}
    for tag in ("without", "with", "with", "without"):
        feat = (dm_cached if tag == "with" else dm_plain).featurizer
        raw = raws[tag]
        ms.setdefault(tag, []).append(
            cuda_ms(lambda: feat.featurize_raw(raw, 0), 3))
    log(f"[caches] ({card}) featurize of that batch, in turns without, "
        f"with, with, without the F0 cache: without "
        + ", ".join(f"{x:.2f}" for x in ms["without"]) + " ms; with "
        + ", ".join(f"{x:.2f}" for x in ms["with"]) + " ms")
    return {k: sum(v) / len(v) for k, v in ms.items()}


def _caches_f0(argv: list, path: str, card: str) -> tuple:
    """The F0 cache of ``argv``'s corpus through the script's entry point,
    in turns eager, graphed, graphed, eager (each graphed build a pool of
    its own; the first graphed cache at ``path``, the others beside it):
    every cache byte for byte the first eager one's (the same records in
    the same order), the seconds of each build, each graphed build's
    warm-ups, captures and replays. Returns the first graphed build's
    (records, seconds)."""
    import os
    from radmmm_torch.scripts import build_f0_cache
    from radmmm_torch.utils.graphs import GraphPool
    orig, runs = build_f0_cache.build_f0_cache, []
    try:
        for i, way in enumerate(("eager", "graphed", "graphed", "eager")):
            pool = GraphPool() if way == "graphed" else None
            out = path if i == 1 else f"{path}_{i}"
            build_f0_cache.build_f0_cache = functools.partial(orig,
                                                              pool=pool)
            t0 = time.perf_counter()
            n = build_f0_cache.main(argv + ["-o", out])
            torch.cuda.synchronize()
            runs.append((way, n, time.perf_counter() - t0, out, pool))
    finally:
        build_f0_cache.build_f0_cache = orig

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    same = all(read(r[3] + ext) == read(runs[0][3] + ext)
               for r in runs for ext in (".dat", ".idx"))
    log(f"[caches] ({card}) build_f0_cache in turns eager, graphed, "
        f"graphed, eager: records {[r[1] for r in runs]}, every cache "
        f"byte-equal to the first {same}; seconds "
        + ", ".join(f"{r[0]} {r[2]:.3f}" for r in runs) + "; pYIN's graphs "
        "(warm-ups, captures, replays, capture s, pool MiB): " + "; ".join(
            f"{p.warmups}, {len(p.captures)}, {p.replays}, "
            f"{sum(c.seconds for c in p.captures):.3f}, "
            f"{sum(c.pool_bytes for c in p.captures) / 2**20:.1f}"
            for *_, p in runs if p is not None))
    if not same or len({r[1] for r in runs}) != 1:
        fail("the graphed F0 caches are not the eager ones")
    for r in runs:
        if r[3] != path:
            for ext in (".dat", ".idx"):
                os.remove(r[3] + ext)
    return runs[1][1:3]


def _caches_overlay(root: str, corpus: dict, tag: str,
                    caches: dict = None) -> str:
    """The overlay over stack (2) for one fit of the caches phase: the
    synthetic corpus (and, given ``caches``, its audio and F0 caches),
    CACHE_STEPS steps, no validation, one checkpoint at the end, the
    phase switches of the fit phase and the profiled window."""
    import os
    data = _data_overlay(root, corpus, RADTTS_STACK[5], ("LJS",))
    if caches:
        data.update(lmdb_cache_path=caches["audio"],
                    f0_cache_path=caches["f0"])
    return _write_overlay(root, f"overlay_{tag}.yaml", {
        "model": {"output_directory": os.path.join(root, f"run_{tag}"),
                  "iters_per_checkpoint": 1000,
                  "binarization_start_iter": FIT_BINARIZE_FROM,
                  "decoder_loss": {"init_args": {"kl_loss_start_iter": 4}}},
        "trainer": {"max_steps": CACHE_STEPS, "val_check_interval": 1000,
                    "log_interval": 1,
                    "profile_dir": os.path.join(root, f"profile_{tag}"),
                    "profile_start_step": CACHE_PROFILE_FROM,
                    "profile_n_steps": CACHE_STEPS - CACHE_PROFILE_FROM},
        "data": data})


@tf32_off()
def phase_caches(seed: int) -> dict:
    """The feature caches on the card: both caches of a synthetic 22,050
    Hz corpus built through the two scripts' entry points, the cache-fed
    batch against the compute path, ``native.mas_batch_cpu`` against K3,
    then stack (2)'s ``fit`` to CACHE_STEPS without and with the caches.
    Returns the kernels' launches of the two fits (the main path)."""
    import os
    from radmmm_torch.data.collate import Featurizer
    from radmmm_torch.data.module import AudioDataModule
    from radmmm_torch.scripts import build_audio_cache, build_f0_cache
    from radmmm_torch.training.loop import Trainer
    from radmmm_torch.utils.config import (load_configs,
                                           translate_reference_data_config)
    from radmmm_torch.utils.device import card_line
    card = card_line()
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="radmmm_caches_")
    try:
        corpus = fit_corpus(root, seed, RADTTS_TRAIN, RADTTS_SOURCES,
                            RADTTS_SR)
        caches = {"audio": os.path.join(root, "cache", "audio"),
                  "f0": os.path.join(root, "cache", "f0")}
        plain = [a for c in RADTTS_STACK + (
            _caches_overlay(root, corpus, "without"),) for a in ("-c", c)]
        cached = [a for c in RADTTS_STACK + (
            _caches_overlay(root, corpus, "with", caches),)
            for a in ("-c", c)]
        t0 = time.perf_counter()
        n_audio = build_audio_cache.main(plain + ["-o", caches["audio"]])
        audio_s = time.perf_counter() - t0
        n_f0, f0_s = _caches_f0(plain, caches["f0"], card)
        n_lines = RADTTS_TRAIN + FIT_VAL
        size = sum(os.path.getsize(caches[k] + ext)
                   for k in caches for ext in (".dat", ".idx"))
        log(f"[caches] ({card}) build_audio_cache: {n_audio} records in "
            f"{audio_s:.2f} s; build_f0_cache (pYIN on the card, batches of "
            f"8, graphed): {n_f0} records in {f0_s:.2f} s; "
            f"{size / 1e6:.1f} MB on disk")
        if n_audio != n_lines or n_f0 != n_lines:
            fail(f"expected {n_lines} records in each cache, got audio "
                 f"{n_audio}, F0 {n_f0}")

        def module(argv):
            cfg = load_configs(argv[1::2])
            dm = AudioDataModule(**translate_reference_data_config(cfg))
            dm.setup("fit")
            return dm

        feat_ms = _caches_features(module(plain), module(cached), card)
        _caches_mas(seed)

        # the main path: counts from zero, the two fits, counts read after
        _zero_counters()
        runs = {}
        for tag, argv in (("without", plain), ("with", cached)):
            steps, fed, loaded = [], [], []
            featurize_raw, load = Featurizer.featurize_raw, \
                Featurizer.__call__

            def recording(self, raw, noise_key, noise=None):
                fed.append("cached_f0" in raw)
                return featurize_raw(self, raw, noise_key, noise=noise)

            def loading(self, host_batch):
                loaded.append(1)
                return load(self, host_batch)

            Featurizer.featurize_raw, Featurizer.__call__ = recording, \
                loading
            try:
                with _counted(Trainer, "_run_step", steps):
                    dm, tr, _, fit_s = _run_cli(
                        ["fit"] + argv, f"fit to {CACHE_STEPS} steps "
                        f"{tag} the caches", "caches")
            finally:
                Featurizer.featurize_raw, Featurizer.__call__ = \
                    featurize_raw, load
            # every batch featurized carried its tracks with the caches,
            # none without; they are the loader's (the first batch and
            # those loaded with it) and each step that ran the step's
            # function: a signature's warm-up (the steps that did not
            # replay) and its capture (a replay featurizes the raw batch
            # of the keys it was captured with)
            s = tr.stats
            captured = sum(c.name == "train_step"
                           for c in tr._graph_pool.captures)
            want_fed = len(loaded) + s["steps"] - s["graphed_steps"] \
                + captured
            if not loaded or len(fed) != want_fed or \
                    set(fed) != {tag == "with"}:
                fail(f"fit {tag} the caches: {len(fed)} featurized batches"
                     f" (expected {len(loaded)} loaded, "
                     f"{s['steps'] - s['graphed_steps']} warm-ups and "
                     f"{captured} captures of the step), carrying F0 "
                     f"tracks {fed}")
            if (tag == "with") != (dm.trainset.f0_cache is not None
                                   and dm.trainset.audio_cache is not None):
                fail(f"fit {tag} the caches read the wrong dataset")
            for i, got in enumerate(steps):
                want = dict(FIT_STEP)
                if i < FIT_BINARIZE_FROM:
                    want["mas_width1"] = 0
                if got != want:
                    fail(f"caches: fit {tag} the caches, step {i + 1} "
                         f"launched {got}, expected {want}")
            rows = _metrics_rows(os.path.join(root, f"run_{tag}"))
            bad = [r for r in rows for k, v in r.items()
                   if k != "step" and "loss" in k and not math.isfinite(v)]
            if bad or [r["step"] for r in rows] != list(
                    range(1, CACHE_STEPS + 1)):
                fail(f"caches: fit {tag} the caches logged {rows}")
            starts, pauses = s["step_starts"], s["pause_s"]
            walls = [1e3 * (starts[i + 1] - starts[i] - pauses.get(i + 1, 0))
                     for i in range(1, CACHE_PROFILE_FROM)]
            runs[tag] = dict(
                walls=walls, fit_s=fit_s,
                loader=100 * s["loader_wait_s"] / s["train_s"],
                busy=s.get("profile_busy_s"), wall=s.get("profile_wall_s"),
                top=s.get("profile_top_ms", [])[:6],
                loss=[r["train/loss"] for r in rows])
        launches = _counters(loaders=True)
        for tag, r in runs.items():
            n = CACHE_STEPS - CACHE_PROFILE_FROM
            step_ms = sum(r["walls"]) / len(r["walls"])
            busy = ("not measured (the profiler saw no device time)"
                    if not r["busy"] else
                    f"{1e3 * r['busy'] / n:.1f} ms a step, "
                    f"{100 * r['busy'] / r['wall']:.1f}% of the profiled "
                    f"wall, {1e5 * r['busy'] / n / step_ms:.1f}% of the "
                    f"unprofiled {step_ms:.2f} ms a step")
            log(f"[caches] ({card}) fit {tag} the caches: steps 2-"
                f"{CACHE_PROFILE_FROM} " + ", ".join(
                    f"{w:.1f}" for w in r["walls"])
                + f" ms (mean {step_ms:.2f}; "
                f"featurize, loader and logging in); featurize "
                f"{feat_ms[tag]:.2f} ms a batch; the loader "
                f"{r['loader']:.1f}% of the {CACHE_STEPS} steps; steps "
                f"{CACHE_PROFILE_FROM + 1}-{CACHE_STEPS} profiled: the card "
                f"busy {busy}; fit wall {r['fit_s']:.2f} s; train loss by "
                f"step " + ", ".join(f"{x:.4f}" for x in r["loss"]))
            log(f"[caches] fit {tag} the caches, the profiled steps' top "
                f"kernels, ms summed: " + "; ".join(
                    f"{name[:60]} {ms:.2f}" for name, ms in r["top"]))
        log(f"[caches] kernel launches on each of the {CACHE_STEPS} "
            f"training steps of both fits as expected: {FIT_STEP} "
            f"(mas_width1 0 before step {FIT_BINARIZE_FROM + 1}); the two "
            f"fits launched {launches}")
        log(f"[caches] phase in {time.perf_counter() - t_phase:.1f} s")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# the m12 phase: the spline flow of configs/radtts_model.yaml (n_splines
# 2) at the training batch, both new affine couplings at the flow's widths
# (160 channels of z, the 1,048-channel context), and the alternative
# decoders at their default widths on a shorter batch, whose HiFi-GAN v1
# makes 65,536 samples an item
M12_ALT_B, M12_ALT_T_TEXT, M12_ALT_T_MEL = 4, 64, 256
M12_TIMED = 3
# card against CPU, f32 on both with TF32 off, sums in another order: loss
# terms and running statistics relative to their size, the flow's
# gradients as the train_parity phase holds them (each leaf's worst
# difference over its largest), the mel of the flow's sampling direction
# absolute, as the parity phase; a coupling's outputs and the sampled
# diffusion mel relative to their peak
M12_RTOL = 1e-4
M12_OUT_RTOL = 1e-4
# the spline couplings' parameters (their FiLM stacks) are held by the
# Frobenius norm of each leaf's difference over the leaf's, at the bound of
# the others: a FiLM leaky ReLU's pre-activation within rounding of 0 lands
# on the other side in one run (slope 1 against 0.01), which moves that one
# element's gradient by 99%, a few percent of a leaf's largest entry but
# about 1e-3 of its norm, where an error in a FiLM conv's backward moves the
# whole leaf (radmmm_torch/scripts/spline_grad_precision.py counts the
# flips and plants such an error; numbers in PERF.md)


def _nudge_m12(module) -> None:
    """Small random weights in the zero-initialised last convs of the
    M12 parameter predictors (FiLM stacks, simple conv nets) and of the
    WN couplings, so that no coupling is the identity."""
    from radmmm_torch.ops.coupling import FiLMStack, SimpleConvNet
    _nudge_couplings(module)
    with torch.no_grad():
        for m in module.modules():
            last = (m.end if isinstance(m, FiLMStack)
                    else m.last if isinstance(m, SimpleConvNet) else None)
            if last is not None:
                last.weight.normal_(0.0, 1e-3)
                last.bias.normal_(0.0, 1e-3)


def _rel_err(got, want) -> float:
    """max |got - want| over max |want| (at least 1e-12)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-12))


def _check(tag: str, what: str, err: float, bound: float) -> None:
    log(f"[{tag}] {what}: {err:.3e} (bound {bound:g})")
    if not (math.isfinite(err) and err <= bound):
        fail(f"{tag}: {what} {err:.3e} exceeds {bound:g}")


class _Launches:
    """The kernels' launches of the phase's card calls, each part's
    checked against what the code launches."""

    def __init__(self, tag):
        self.tag, self.want = tag, {k: 0 for k in _counters()}

    @contextlib.contextmanager
    def part(self, what: str, per_call: dict, calls: int = 1):
        before = _counters()
        yield
        after = _counters()
        got = {k: after[k] - before[k] for k in after}
        want = {k: per_call.get(k, 0) * calls for k in after}
        if got != want:
            fail(f"{self.tag}: {what} launched {got}, expected {want}")
        for k, n in want.items():
            self.want[k] += n


def _m12_flow(seed: int, launches: _Launches, card: str) -> None:
    """(a) The spline flow at full width: one training forward and
    backward on the card and the CPU from the same weights and batch (the
    flow loss, every gradient, the running statistics after it), then
    ``infer`` at sigma 0 on the updated running statistics; ms of each on
    the card."""
    from radmmm_torch.losses.flow import compute_flow_loss
    from radmmm_torch.models.flow_decoder import RADMMMFlow
    from radmmm_torch.ops.coupling import SplineCoupling
    from radmmm_torch.utils.config import (load_configs,
                                           translate_reference_model_config)
    from radmmm_torch.utils.masking import SeqLens
    tag = "m12"
    dec = dict(translate_reference_model_config(load_configs(
        ["configs/radtts_model.yaml"]))["tts"]["decoder"], n_splines=2)
    torch.manual_seed(seed)
    cpu = RADMMMFlow(**dec)
    _nudge_m12(cpu)
    n_spline = sum(isinstance(f.coupling, SplineCoupling) for f in cpu.flows)
    n_params = sum(p.numel() for p in cpu.parameters())
    log(f"[{tag}] (a) configs/radtts_model.yaml's decoder with n_splines 2: "
        f"{len(cpu.flows)} flows ({n_spline} spline couplings with FiLM "
        f"stacks of 512, the rest WN of {dec['n_conv_layers_per_step']} x "
        f"1024), {n_params / 1e6:.1f} M parameters; B={TRAIN_B}, "
        f"T_mel={TRAIN_T_MEL}")
    rng = np.random.default_rng(seed + 11)
    B, T = TRAIN_B, TRAIN_T_MEL
    arrays = dict(
        mel=rng.standard_normal((B, T, 80)).astype(np.float32),
        spk=rng.standard_normal((B, 16)).astype(np.float32),
        ctx=rng.standard_normal((B, T, 512)).astype(np.float32),
        acc=rng.standard_normal((B, 8)).astype(np.float32),
        f0=rng.uniform(4, 6, (B, T)).astype(np.float32),
        en=rng.uniform(0, 1, (B, T)).astype(np.float32),
        txt=rng.standard_normal((B, T // 4, 512)).astype(np.float32),
        lens=np.asarray([T - 16 * i for i in range(B)], np.int32))
    models = {"cuda": copy.deepcopy(cpu).cuda(), "cpu": cpu}
    res = {}

    def train_step(m, a):
        lens = SeqLens.create(a["lens"], T)
        out = m(a["mel"], a["spk"], a["ctx"], lens, f0=a["f0"],
                energy_avg=a["en"], accent_vecs=a["acc"], train=True)
        glens = lens.downsample(2)
        loss, prior = compute_flow_loss(
            out["z_mel"], out["log_det_W_list"], out["log_s_list"],
            glens.lengths.sum().float(), out["z_mel"].shape[-1],
            glens.fmask())
        loss.backward()
        return loss.detach(), prior.detach()

    def infer(m, a):
        dur = torch.full(a["txt"].shape[:2], 4, dtype=torch.int32,
                         device=a["txt"].device)
        with torch.no_grad():
            return m.infer(a["spk"], a["txt"], 0.0, dur=dur, f0=a["f0"],
                           energy_avg=a["en"],
                           lens=SeqLens.create(a["lens"], T),
                           accent_vecs=a["acc"])["mel"]

    for where, m in models.items():
        a = {k: torch.from_numpy(v).to(where) for k, v in arrays.items()}
        t0 = time.perf_counter()
        with (launches.part("the flow's training step",
                            {"lstm_recurrence": 1, "lstm_recurrence_bwd": 1,
                             **_wn_launches(cpu, True)})
              if where == "cuda" else contextlib.nullcontext()):
            loss, prior = train_step(m, a)
        if where == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        with (launches.part("the flow's infer", {"lstm_recurrence": 1,
                                                 **_wn_launches(cpu, False)})
              if where == "cuda" else contextlib.nullcontext()):
            mel = infer(m, a)
        if where == "cuda":
            torch.cuda.synchronize()
        res[where] = dict(loss=loss, prior=prior, mel=mel)
        log(f"[{tag}] (a) {where}: training step {(t1 - t0) * 1e3:.1f} ms "
            f"(first call), infer at sigma 0 "
            f"{(time.perf_counter() - t1) * 1e3:.1f} ms, flow loss "
            f"{loss.item():.6f}")
    g, c = res["cuda"], res["cpu"]
    for k in ("loss", "prior"):
        _check(tag, f"(a) flow {k} card vs CPU, relative",
               abs(g[k].item() - c[k].item()) / abs(c[k].item()), M12_RTOL)
    errs = leaf_grad_errors(models["cuda"], models["cpu"])
    log(f"[{tag}] (a) gradients of {len(errs)} parameters, worst: " + ", "
        .join(f"{n} {e:.2e} (max |grad| {g:.2e})" for e, n, g in errs[:4]))
    other = [e for e in errs if ".film." not in e[1]]
    spline = [e for e in leaf_grad_errors(models["cuda"], models["cpu"],
                                          frobenius=True)
              if ".film." in e[1]]
    _check(tag, f"(a) worst of {len(other)} gradient leaves outside the "
           f"spline couplings ({other[0][1]}), card vs CPU over the leaf's "
           "largest", other[0][0], GRAD_PARITY_RTOL)
    _check(tag, f"(a) worst of the spline couplings' {len(spline)} gradient "
           f"leaves ({spline[0][1]}), card vs CPU, Frobenius norms",
           spline[0][0], GRAD_PARITY_RTOL)
    stats = {k: t for k, t in models["cpu"].state_dict().items()
             if k.endswith((".bn.mean", ".bn.var"))}
    card_sd = models["cuda"].state_dict()
    moved = max(float((t - (0.0 if k.endswith("mean") else 1.0)).abs().max())
                for k, t in stats.items())
    _check(tag, f"(a) {len(stats)} running statistics after the step, card "
           f"vs CPU, worst relative (moved by up to {moved:.3f} from init)",
           max(_rel_err(card_sd[k], t) for k, t in stats.items()), M12_RTOL)
    _check(tag, "(a) infer at sigma 0 on the running statistics, mel card "
           f"vs CPU, max abs (mel peak {float(c['mel'].abs().max()):.2f})",
           float((g["mel"].cpu() - c["mel"]).abs().max()), PARITY_ATOL)
    # timing on a copy of the card's model, so the compared one is intact
    m = copy.deepcopy(models["cuda"])
    a = {k: torch.from_numpy(v).cuda() for k, v in arrays.items()}
    k7 = _wn_launches(cpu, True)
    with launches.part("the timed flow steps and infers",
                       {"lstm_recurrence": 2, "lstm_recurrence_bwd": 1, **k7,
                        "wn_conv_fwd": 2 * k7.get("wn_conv_fwd", 0)},
                       1 + M12_TIMED):
        step_ms = cuda_ms(lambda: train_step(m, a), M12_TIMED)
        infer_ms = cuda_ms(lambda: infer(m, a), M12_TIMED)
    log(f"[{tag}] (a) ({card}) the flow's training forward "
        f"and backward {step_ms:.2f} ms, infer at sigma 0 {infer_ms:.2f} ms "
        f"(B={B}, T_mel={T}, mean of {M12_TIMED} after a warm-up)")


def _m12_couplings(seed: int, launches: _Launches) -> None:
    """(b) AffineCoupling with simple_conv and with film_stack at the
    flow's widths: forward and inverse on the card against the CPU, and
    the card's round trip."""
    from radmmm_torch.ops.coupling import AffineCoupling
    from radmmm_torch.utils.masking import SeqLens
    tag = "m12"
    B, T, C, CTX = TRAIN_B, TRAIN_T_MEL // 2, 160, 1048
    rng = np.random.default_rng(seed + 12)
    z = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((B, T, CTX)).astype(
        np.float32))
    lens = torch.tensor([T - 8 * i for i in range(B)], dtype=torch.int32)
    for model in ("simple_conv", "film_stack"):
        torch.manual_seed(seed)
        cpu = AffineCoupling(C, CTX, 4, affine_model=model,
                             scaling_fn="tanh", use_partial_padding=True)
        _nudge_m12(cpu)
        gpu = copy.deepcopy(cpu).cuda()
        out = {}
        for where, m in (("cuda", gpu), ("cpu", cpu)):
            mask = SeqLens.create(lens, T).mask.to(where)
            zz, cc = z.to(where), ctx.to(where)
            with torch.no_grad(), (
                    launches.part(f"the {model} coupling", {})
                    if where == "cuda" else contextlib.nullcontext()):
                fwd, log_s = m(zz, cc, mask)
                inv = m.inverse(fwd, cc, mask)
            out[where] = (fwd, log_s, inv, mask)
        (gf, gl, gi, mask), (cf, cl, ci, _) = out["cuda"], out["cpu"]
        n = sum(p.numel() for p in cpu.parameters())
        for what, a, b in (("forward z", gf, cf), ("log s", gl, cl),
                           ("inverse", gi, ci)):
            _check(tag, f"(b) {model} ({n / 1e6:.1f} M parameters) {what} "
                   "card vs CPU over its peak", _rel_err(a, b), M12_OUT_RTOL)
        m3 = mask.float()[..., None]
        trip = float(((gi - z.cuda()) * m3).abs().max())
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: gpu(z.cuda(), ctx.cuda(), mask), 3)
            inv_ms = cuda_ms(lambda: gpu.inverse(gf, ctx.cuda(), mask), 3)
        log(f"[{tag}] (b) {model}: the card's round trip max |z - "
            f"inverse(forward(z))| {trip:.3e} on valid frames (|z| up to "
            f"{float(z.abs().max()):.2f}); forward {fwd_ms:.2f} ms, inverse "
            f"{inv_ms:.2f} ms (B={B}, T={T}, {C} channels, context {CTX})")
        if not trip <= 1e-4:
            fail(f"{tag}: the {model} coupling's round trip is off by "
                 f"{trip:.3e}")


def _m12_alt_decoders(seed: int, launches: _Launches) -> None:
    """(c) The three alternative decoders at their default widths with
    their losses: the attention terms from the port's ConvAttention on
    the batch (MAS K3, the CTC loss K1 and its backward K2 on the card),
    the loss terms card against CPU; the diffusion decoder's 100-step
    ancestral sampling with its draws fed, and one E2E GAN-loss step
    (Adam) of HiFi-GAN v1 on the card."""
    from radmmm_torch.losses.flow import (RADTTSDeterministicLoss,
                                          RADTTSDiffusionLoss,
                                          RADTTSE2EGANLoss)
    from radmmm_torch.models.alt_decoders import (DeterministicDecoder,
                                                  DiffusionDecoder,
                                                  E2ETTSDecoder)
    from radmmm_torch.ops.alignment import binarize_attention
    from radmmm_torch.ops.attention import ConvAttention
    from radmmm_torch.training.step import total_loss
    from radmmm_torch.utils.masking import SeqLens
    tag = "m12"
    B, Tt, Tm = M12_ALT_B, M12_ALT_T_TEXT, M12_ALT_T_MEL
    rng = np.random.default_rng(seed + 13)
    prior = rng.uniform(0.1, 1.0, (B, Tm, Tt)).astype(np.float32)
    prior /= prior.sum(-1, keepdims=True)
    arrays = dict(
        keys=rng.standard_normal((B, Tt, 512)).astype(np.float32),
        txt=rng.standard_normal((B, Tt, 512)).astype(np.float32),
        mel=rng.standard_normal((B, Tm, 80)).astype(np.float32),
        spk=rng.standard_normal((B, 16)).astype(np.float32),
        f0=rng.uniform(4, 6, (B, Tm)).astype(np.float32),
        en=rng.uniform(0, 1, (B, Tm)).astype(np.float32),
        prior=prior,
        audio=(0.1 * rng.standard_normal((B, Tm * HOP))).astype(np.float32),
        in_lens=np.asarray([Tt - 5 * i for i in range(B)], np.int32),
        out_lens=np.asarray([Tm - 24 * i for i in range(B)], np.int32))
    gen = torch.Generator().manual_seed(seed)
    n_steps = DiffusionDecoder().schedule.n_steps
    fed = dict(t=torch.randint(0, n_steps, (B,), generator=gen),
               noise=torch.randn((B, Tm, 80), generator=gen),
               x0=torch.randn((B, Tm, 80), generator=gen),
               zs=torch.randn((n_steps, B, Tm, 80), generator=gen))

    def attention(att, a):
        in_lens = SeqLens.create(a["in_lens"], Tt)
        out_lens = SeqLens.create(a["out_lens"], Tm)
        soft, logprob = att(a["mel"], a["keys"], key_mask=in_lens.mask,
                            attn_prior=a["prior"])
        hard = binarize_attention(soft, in_lens.lengths, out_lens.lengths)
        return (dict(attn=hard, attn_soft=soft, attn_logprob=logprob),
                torch.bmm(hard, a["txt"]), in_lens, out_lens)

    # each -> (loss terms, the decoder's predictions)
    def det(mods, a, f):
        att, dec = mods
        out, ctx, il, ol = attention(att, a)
        pred = dec(ctx, a["spk"], ol, a["f0"], a["en"])
        out.update(mel=a["mel"], **pred)
        return RADTTSDeterministicLoss()(out, il, ol, True), pred

    def diff(mods, a, f):
        att, dec = mods
        out, ctx, il, ol = attention(att, a)
        pred = dec(a["mel"], ctx, ol, t=f["t"], noise=f["noise"])
        out.update(pred)
        return RADTTSDiffusionLoss()(out, il, ol, True), {
            "noise_hat": pred["noise_hat"]}

    def e2e(mods, a, f):
        att, dec = mods
        out, ctx, il, ol = attention(att, a)
        pred = dec(ctx, a["spk"], ol, a["f0"], a["en"])
        out.update(pred)
        return RADTTSE2EGANLoss()(out, a["audio"], ol.lengths.float() * HOP,
                                  il, ol, True), pred

    decoders = (
        ("DeterministicDecoder", lambda: DeterministicDecoder(), det),
        ("DiffusionDecoder", lambda: DiffusionDecoder(), diff),
        ("E2ETTSDecoder (HiFi-GAN v1)", lambda: E2ETTSDecoder(), e2e))
    for name, build, fn in decoders:
        torch.manual_seed(seed)
        cpu = (ConvAttention(80, 512), build())
        gpu = tuple(copy.deepcopy(m).cuda() for m in cpu)
        n = sum(p.numel() for p in cpu[1].parameters())
        res, preds = {}, {}
        for where, mods in (("cuda", gpu), ("cpu", cpu)):
            a = {k: torch.from_numpy(v).to(where) for k, v in arrays.items()}
            f = {k: v.to(where) for k, v in fed.items()}
            t0 = time.perf_counter()
            if where == "cpu":
                with torch.no_grad():
                    ld, pred = fn(mods, a, f)
                res[where] = {k: v.item() for k, (v, _) in ld.items()}
                preds[where] = pred
                continue
            params = [p for m in mods for p in m.parameters()]
            opt = torch.optim.Adam(params, lr=1e-4)

            def loss_step():
                opt.zero_grad()
                ld, pred = fn(mods, a, f)
                total_loss(ld).backward()
                opt.step()
                return ld, pred

            per_step = {"ctc_alpha": 1, "ctc_beta": 1, "mas_width1": 1}
            with launches.part(f"the {name} loss step", per_step):
                ld, pred = loss_step()
            preds[where] = {k: v.detach() for k, v in pred.items()}
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            res[where] = {k: v.item() for k, (v, _) in ld.items()}
            with launches.part(f"the {name} timed steps", per_step,
                               1 + M12_TIMED):
                ms = cuda_ms(loss_step, M12_TIMED)
            log(f"[{tag}] (c) {name} ({n / 1e6:.2f} M parameters): one loss "
                f"step on the card (forward, backward, Adam) {ms:.2f} ms "
                f"(mean of {M12_TIMED} after the first, {first_ms:.1f} ms; "
                f"B={B}, T_text={Tt}, T_mel={Tm}); "
                + ", ".join(f"{k} {v:.5f}" for k, v in res[where].items()))
        log(f"[{tag}] (c) {name} loss terms, card | CPU, all digits: "
            + "; ".join(f"{k} {res['cuda'][k]!r} | {v!r}"
                        for k, v in res["cpu"].items()))
        worst = max(abs(res["cuda"][k] - v) / max(abs(v), 1e-6)
                    for k, v in res["cpu"].items())
        _check(tag, f"(c) {name} loss terms card vs CPU, worst relative",
               worst, TRAIN_PARITY_RTOL)
        # the predictions: the loss terms at init are near their targets'
        # own statistics and can hide a difference in the decoder
        for k, want in preds["cpu"].items():
            _check(tag, f"(c) {name} {k} card vs CPU over its peak "
                   f"({float(want.abs().max()):.3g})",
                   _rel_err(preds["cuda"][k], want), M12_OUT_RTOL)
        if name == "DiffusionDecoder":
            # 100 ancestral steps with x0 and each step's z fed; the CPU
            # samples the batch's first item only (the items are
            # independent)
            with torch.no_grad(), launches.part("the sampling's attention",
                                                {"mas_width1": 1}):
                _, ctx, _, ol = attention(gpu[0], {
                    k: torch.from_numpy(v).cuda() for k, v in arrays.items()})
            with torch.no_grad(), launches.part(
                    "the 100-step sampling", {}, 2):
                t0 = time.perf_counter()
                mel = gpu[1].infer(ctx, ol, x=fed["x0"].cuda(),
                                   zs=fed["zs"].cuda())
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                ms2 = cuda_ms(lambda: gpu[1].infer(
                    ctx, ol, x=fed["x0"].cuda(), zs=fed["zs"].cuda()), 1)
            ol1 = SeqLens.create(ol.lengths[:1].cpu(), Tm)
            with torch.no_grad():
                want = copy.deepcopy(gpu[1]).cpu().infer(
                    ctx[:1].cpu(), ol1, x=fed["x0"][:1], zs=fed["zs"][:, :1])
            log(f"[{tag}] (c) DiffusionDecoder: {n_steps}-step ancestral "
                f"sampling on the card {ms:.1f} ms (first call), {ms2:.1f} "
                f"ms (second; B={B}, T_mel={Tm}); mel peak "
                f"{float(mel.abs().max()):.3f}")
            if not torch.isfinite(mel).all():
                fail(f"{tag}: the diffusion decoder sampled non-finite mels")
            _check(tag, "(c) the sampled mel's first item card vs CPU over "
                   "its peak", _rel_err(mel[:1], want), M12_OUT_RTOL)


@tf32_off()
def phase_m12(seed: int) -> dict:
    """The M12 modules on the card against the CPU from the same weights
    and inputs, TF32 off: (a) the spline flow, (b) the simple_conv and
    film_stack couplings, (c) the three alternative decoders with their
    losses. Returns the kernels' launches of the phase's card calls, each
    part's checked against what it launches."""
    from radmmm_torch.utils.device import card_line
    tag, card = "m12", card_line()
    launches = _Launches(tag)
    # the main path: counts from zero, the phase, counts read after
    _zero_counters()
    t0 = time.perf_counter()
    _m12_flow(seed, launches, card)
    _m12_couplings(seed, launches)
    _m12_alt_decoders(seed, launches)
    got = _counters()
    if got != launches.want:
        fail(f"{tag}: launched {got}, expected {launches.want}")
    log(f"[{tag}] kernel launches of the phase as expected: {got}; "
        f"{time.perf_counter() - t0:.1f} s ({card})")
    return got


# the vocoder phase: HiFi-GAN v1 trained at its published batch on
# segments of 8,192 samples (VocoderTrainConfig's defaults), from a corpus
# of VOC_TRAIN lines of each source, so every batch holds VOC_B items;
# the resumed run's first step warms its graph up and its second captures
# it, so the profiled steps are the two after those
VOC_TRAIN, VOC_B = 32, 16
VOC_STEPS, VOC_RESUME_STEPS, VOC_PROFILED = 6, 10, 2
VOC_PROFILED_FROM = VOC_RESUME_STEPS - VOC_PROFILED
VOC_WG_STEPS = 4
VOC_MELS = (4, 390)
# iSTFTNet's C8C8I: two upsamplings of 8, then an inverse STFT of 16
# points at hop 4 (a 256-sample hop in all), at v1's 512 channels
ISTFTNET = dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                gen_istft_n_fft=16, gen_istft_hop=4)
# card against CPU, f32 with TF32 off: each vocoder's audio within 1e-4
# of its peak (a deep conv stack in f32 in another summation order); the
# CPU vocodes the batch's first mel (WaveGlow its first 96 frames: 8
# TFLOP a batch is minutes on the host)
VOCODE_RTOL = 1e-4
WG_CPU_FRAMES = 96
# each trainer's step graphed against eager (pool None), at the phase's
# batch: VOC_PAIR_STEPS steps, HiFi-GAN's input blurred with p 0.5 from
# seed 1 (steps 0, 2, 4 and 7 of 8 blur: two signatures, each warmed up,
# captured and replayed twice); the vocoder-fit runs' ms a step over the
# steps that replay (3 on), graphed against an eager run of the same loop
VOC_PAIR_STEPS, VOC_BLUR_P, VOC_BLUR_SEED = 8, 0.5, 1
# where the graphed steps are not bit-equal to eager (an op without a
# deterministic CUDA path), the gaps allowed after VOC_PAIR_STEPS steps:
# the losses relative, the parameters absolute (0.25% of what 8 Adam
# steps at lr 2e-4 can move an element), or 4x a second eager run's gaps
VOC_GRAPH_LOSS_RTOL, VOC_GRAPH_PARAM_ATOL = 1e-4, 4e-6


def write_g_file(root: str, seed: int, sr: int = FIT_SR):
    """An upstream-format HiFi-GAN v1 ``g_*`` file (at ``sr``, 16 kHz by
    default, the recipe's 80 mel channels) from random weights of
    ``seed``, and its config json -> (file, config)."""
    import os
    from radmmm_torch.vocoder.hifigan import (Generator, HiFiGANConfig,
                                              upstream_generator_state_dict)
    torch.manual_seed(seed)
    cfg = HiFiGANConfig(sampling_rate=sr)
    path = os.path.join(root, "g_00000000")
    torch.save({"generator": upstream_generator_state_dict(
        Generator(cfg))}, path)
    cfg_path = os.path.join(root, f"config_{sr // 1000}khz.json")
    with open(cfg_path, "w") as f:
        json.dump({"resblock": cfg.resblock,
                   "upsample_rates": cfg.upsample_rates,
                   "upsample_kernel_sizes": cfg.upsample_kernel_sizes,
                   "upsample_initial_channel": cfg.upsample_initial_channel,
                   "resblock_kernel_sizes": cfg.resblock_kernel_sizes,
                   "resblock_dilation_sizes": cfg.resblock_dilation_sizes,
                   "num_mels": cfg.n_mel_channels,
                   "sampling_rate": cfg.sampling_rate}, f)
    return path, cfg_path


def write_waveglow_file(root: str, seed: int):
    """An upstream-format WaveGlow file at ``WaveGlow()``'s defaults from
    random weights of ``seed`` (the couplings' zero-initialised ``end``
    convs given small weights, so no coupling is the identity), and its
    train config -> (file, config)."""
    import os
    from radmmm_torch.vocoder.waveglow import (WaveGlow,
                                               upstream_waveglow_state_dict)
    torch.manual_seed(seed)
    wg = WaveGlow()
    with torch.no_grad():
        for i in range(wg.n_flows):
            getattr(wg, f"wn_{i}").end.weight.normal_(0.0, 1e-3)
    path = os.path.join(root, "waveglow_256channels.pt")
    torch.save({"model": upstream_waveglow_state_dict(wg)}, path)
    cfg_path = os.path.join(root, "waveglow_config.json")
    with open(cfg_path, "w") as f:
        json.dump({"waveglow_config": {
            "n_mel_channels": 80, "n_flows": 12, "n_group": 8,
            "n_early_every": 4, "n_early_size": 2,
            "WN_config": {"n_layers": 8, "n_channels": 256,
                          "kernel_size": 3}},
            "data_config": {"hop_length": HOP}}, f)
    return path, cfg_path


def _vocoder_fit(base, run_dir, tag, **vocoder):
    """``python -m radmmm_torch.training.cli vocoder-fit`` in this process
    with a vocoder section over ``base`` -> (its trainer, what it
    printed, seconds)."""
    import os
    section = dict(output_directory=run_dir, log_interval=1, **vocoder)
    overlay = _write_overlay(os.path.dirname(run_dir),
                             f"vocoder_{os.path.basename(run_dir)}.yaml",
                             {"vocoder": section})
    _, trainer, out, s = _run_cli(["vocoder-fit"] + base + ["-c", overlay],
                                  tag, "vocoder")
    return trainer, out, s


def _walls(stats) -> list:
    """Each step's wall, start to next start (the last: to the end of its
    run, its save excluded)."""
    starts = stats["step_starts"]
    ends = starts[1:] + [stats["end"]]
    return [e - s for s, e in zip(starts, ends)]


def _vocode_check(name, voc_fn, denoiser, cpu_fn, cpu_den, mels,
                  n_cpu, graphed_fn=None) -> None:
    """Time ``voc_fn`` + Denoiser on the card over ``mels``; hold it
    against the CPU on the first mel's first ``n_cpu`` frames; then the
    apply (``graphed_fn``, else ``voc_fn``) with the Denoiser through
    ``vocode_program``'s graph against its eager call, bit for bit under
    deterministic cuDNN, and timed."""
    from radmmm_torch.utils.graphs import GraphPool
    from radmmm_torch.vocoder.utils import get_audio_for_mels, vocode_program

    def run():
        return get_audio_for_mels(mels, name, voc_fn, denoiser)

    ms = cuda_ms(run, 3)
    audio = run()
    part = mels[:1, :n_cpu]
    got = get_audio_for_mels(part, name, voc_fn, denoiser).cpu()
    want = get_audio_for_mels(part.cpu(), name, cpu_fn, cpu_den)
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    log(f"[vocoder] {name}: {tuple(mels.shape)} mels -> audio "
        f"{tuple(audio.shape)} in {ms:.2f} ms with the Denoiser; card "
        f"against CPU on {tuple(part.shape)}: max abs err {err:.3e}, peak "
        f"{peak:.3e} ({err / max(peak, 1e-30):.2e} of it)")
    if not torch.isfinite(audio).all() or audio.shape != (
            mels.shape[0], mels.shape[1] * HOP):
        fail(f"{name}: non-finite audio or shape {tuple(audio.shape)}")
    if err > VOCODE_RTOL * peak:
        fail(f"{name}: card against CPU {err:.3e} over {VOCODE_RTOL} of "
             f"the peak {peak:.3e}")
    fn = graphed_fn or voc_fn
    pool = GraphPool()
    program = vocode_program(name, fn, denoiser, pool)
    with cudnn_deterministic():
        want = get_audio_for_mels(mels, name, fn, denoiser)
        equal = all(torch.equal(program(mels), want) for _ in range(3))
    # timed with a graph captured at cuDNN's defaults, as the eager call
    # runs (a graph replays the algorithms of its capture)
    timed = vocode_program(name, fn, denoiser, GraphPool())
    timed(mels)
    g_ms = cuda_ms(lambda: timed(mels), 3)
    e_ms = cuda_ms(lambda: get_audio_for_mels(mels, name, fn, denoiser), 3)
    log(f"[vocoder] {name}: the apply with the Denoiser through its graph "
        f"(warm-ups {pool.warmups}, captures {len(pool.captures)}, replays "
        f"{pool.replays}, pool "
        f"{sum(c.pool_bytes for c in pool.captures) / 2**20:.1f} MiB) "
        f"against eager, bit-equal {equal}; {g_ms:.2f} ms graphed, "
        f"{e_ms:.2f} eager")
    if not equal or not pool.replays:
        fail(f"{name}: the graphed apply is not the eager one")


def _cufft_c2r_check() -> None:
    """Whether cuFFT's inverse real FFT ignores the imaginary parts of the
    DC and Nyquist bins as the CPU's does (istft_frames zeroes them, so
    the port's answer does not depend on it)."""
    g = torch.Generator().manual_seed(0)
    spec = torch.complex(torch.randn(64, 9, generator=g),
                         torch.randn(64, 9, generator=g))
    want = torch.fft.irfft(spec, n=16)
    got = torch.fft.irfft(spec.cuda(), n=16).cpu()
    log(f"[vocoder] cuFFT C2R with nonzero imaginary DC and Nyquist bins "
        f"against the CPU's: max abs diff {float((got - want).abs().max()):.3e}"
        " (the port zeroes those parts before its inverse FFT)")


class _EagerVocoders:
    """Inside, ``vocoder_fit`` builds its trainers with ``pool=None``:
    every step eager (the graphs' own loop and batches otherwise)."""

    def __enter__(self):
        from radmmm_torch.training import vocoder_loop
        self.loop = vocoder_loop
        self.orig = (vocoder_loop.HiFiGANTrainer,
                     vocoder_loop.WaveGlowTrainer)
        vocoder_loop.HiFiGANTrainer = functools.partial(self.orig[0],
                                                        pool=None)
        vocoder_loop.WaveGlowTrainer = functools.partial(self.orig[1],
                                                         pool=None)
        return self

    def __exit__(self, *exc):
        (self.loop.HiFiGANTrainer, self.loop.WaveGlowTrainer) = self.orig


def _nondeterministic_ops(trainer, batch) -> list:
    """The ops of one eager step that PyTorch names as having no
    deterministic CUDA implementation (its warnings under
    ``use_deterministic_algorithms(True, warn_only=True)``)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            trainer.train_step(batch)
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0]
                   for w in caught if "deterministic" in str(w.message)})


def _vocoder_pair(kind: str, seed: int, card: str) -> dict:
    """A trainer's step through its graphs against the same trainer with
    ``pool=None`` (both from the phase's seed, at its batch), under
    deterministic cuDNN: VOC_PAIR_STEPS steps on the same batches, every
    metric and parameter bit for bit (or, where not, the worst gaps, a
    second eager run's gaps beside them, and the ops PyTorch names as
    nondeterministic); then, with a new pair at cuDNN's defaults (its
    graph captured there: a graph replays the algorithms of its capture)
    and no blur (one signature, as a step of PR 8's baseline), ms a step
    by CUDA events over 4 steps after 3 (warm-up, capture, replay), and
    one traced step each: device busy share and host launch calls."""
    from radmmm_torch.training import vocoder_train as tvt
    from radmmm_torch.vocoder.hifigan import (HiFiGANConfig, blur_draws,
                                              blur_generator)
    cfg = tvt.VocoderTrainConfig(
        sampling_rate=FIT_SR, seed=VOC_BLUR_SEED,
        blur_p=VOC_BLUR_P if kind == "hifigan" else 0.0)

    def build(pool):
        if kind == "hifigan":
            return tvt.HiFiGANTrainer(HiFiGANConfig(sampling_rate=FIT_SR),
                                      cfg, device="cuda", seed=seed,
                                      pool=pool)
        return tvt.WaveGlowTrainer({}, cfg, device="cuda", seed=seed,
                                   pool=pool)

    g = torch.Generator(device="cuda").manual_seed(seed)
    batches = [{"audio": torch.rand((VOC_B, cfg.segment_size), generator=g,
                                    device="cuda") * 0.6 - 0.3}
               for _ in range(VOC_PAIR_STEPS)]
    modules = ("gen", "mpd", "msd") if kind == "hifigan" else ("model",)

    def run(tr):
        with cudnn_deterministic():
            rows = [tr.train_step(b) for b in batches]
        torch.cuda.synchronize()
        params = [p.detach().clone() for m in modules
                  for p in getattr(tr, m).parameters()]
        return rows, params

    def gaps(a, b):
        (ra, pa), (rb, pb) = a, b
        loss = max(float((x[k] - y[k]).abs() / y[k].abs().clamp_min(1e-30))
                   for x, y in zip(ra, rb) for k in y)
        param = max(float((x - y).abs().max()) for x, y in zip(pa, pb))
        return loss, param

    graphed, eager = build(tvt.OWN_POOL), build(None)
    got, want = run(graphed), run(eager)
    equal = all(torch.equal(x[k], y[k]) for x, y in zip(got[0], want[0])
                for k in y) and all(torch.equal(x, y)
                                    for x, y in zip(got[1], want[1]))
    pool = graphed.pool
    branches = ("".join("B" if blur_draws(blur_generator(cfg.seed, i), 4,
                                          cfg.blur_p)[1] else "."
                        for i in range(VOC_PAIR_STEPS))
                if kind == "hifigan" else "")
    log(f"[vocoder] {kind} step graphed against eager, {VOC_PAIR_STEPS} "
        f"steps at {VOC_B} x {cfg.segment_size} under deterministic cuDNN"
        + (f", blurred at steps {branches} (B: blurred)" if branches else "")
        + f": bit-equal {equal}; warm-ups {pool.warmups}, captures "
        f"{len(pool.captures)}, replays {pool.replays}; the pool "
        f"{sum(c.pool_bytes for c in pool.captures) / 2**20:.1f} MiB; "
        f"capture s " + ", ".join(f"{c.seconds:.2f}" for c in pool.captures))
    signatures = 1 + ("B" in branches and "." in branches)
    if pool.warmups != signatures or len(pool.captures) != signatures or             pool.replays != VOC_PAIR_STEPS - signatures:
        fail(f"{kind}: {signatures} signatures, but warm-ups "
             f"{pool.warmups}, captures {len(pool.captures)}, replays "
             f"{pool.replays}")
    if not equal:
        loss, param = gaps(got, want)
        again = run(build(None))
        e_loss, e_param = gaps(again, want)
        ops = _nondeterministic_ops(build(None), batches[0])
        log(f"[vocoder] {kind}: graphed against eager, worst loss "
            f"{loss:.3e} relative, worst parameter {param:.3e}; a second "
            f"eager run against the first {e_loss:.3e}, {e_param:.3e}; ops "
            f"without a deterministic CUDA path: {ops}")
        if not ops or loss > max(4 * e_loss, VOC_GRAPH_LOSS_RTOL) or                 param > max(4 * e_param, VOC_GRAPH_PARAM_ATOL):
            fail(f"{kind}: the graphed steps are not the eager ones")
    del graphed, eager
    torch.cuda.empty_cache()
    batch = batches[0]
    cfg = dataclasses.replace(cfg, blur_p=0.0)
    ms = {}
    for way, pool in (("graphed", tvt.OWN_POOL), ("eager", None)):
        tr = build(pool)
        for _ in range(3):
            tr.train_step(batch)
        ms[way] = cuda_ms(lambda: tr.train_step(batch), 4)
        prof = traced(lambda: tr.train_step(batch))[1]
        ms[way + "_trace"] = prof
        log(f"[vocoder] ({card}) {kind} step {way}: {ms[way]:.2f} ms a step "
            f"(CUDA events, 4 steps, cuDNN's defaults); a traced step: wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['union_ms']:.2f} "
            f"ms ({100 * prof['union_ms'] / prof['wall_ms']:.1f}%; kernel "
            f"time summed {prof['busy_ms']:.2f}), {prof['kernels']} kernels, "
            f"{prof['host_launches']} host launch calls {prof['host_calls']}")
        del tr
    return ms


@tf32_off()
def phase_vocoder(seed: int, work: str) -> dict:
    """vocoder-fit of HiFi-GAN v1 and of WaveGlow at full width on the
    synthetic 16 kHz corpus (batch 16, segments of 8,192), then vocoding
    with the trained HiFi-GAN, an iSTFTNet C8C8I generator and an
    upstream-format WaveGlow file, card against CPU. Returns the trained
    HiFi-GAN's run directory and the kernels' launches on the phase."""
    import os
    from radmmm_torch.utils.checkpoint import CheckpointManager
    from radmmm_torch.utils.device import card_line
    from radmmm_torch.vocoder.hifigan import Generator, HiFiGANConfig
    from radmmm_torch.vocoder.utils import get_vocoder, hifigan_fns
    card = card_line()
    corpus = fit_corpus(os.path.join(work, "corpus"), seed, VOC_TRAIN)
    base = [a for c in RECIPE + (_write_overlay(work, "voc_data.yaml", {
        "data": {**_data_overlay(work, corpus), "batch_size": VOC_B}}),)
            for a in ("-c", c)]
    run_dir = os.path.join(work, "hifigan")

    # the main path: counts from zero, train and vocode, counts read after
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    tr, _, fit_s = _vocoder_fit(base, run_dir, f"vocoder-fit to {VOC_STEPS}",
                                max_steps=VOC_STEPS,
                                iters_per_checkpoint=VOC_STEPS)
    s1 = tr.stats
    saved = {k: v.cpu() for k, v in list(tr.gen.state_dict().items())[:4]}
    n_params = {k: sum(p.numel() for p in getattr(tr, k).parameters())
                for k in ("gen", "mpd", "msd")}
    del tr
    tr2, out2, resume_s = _vocoder_fit(
        base, run_dir, f"resume to {VOC_RESUME_STEPS}, profiled",
        max_steps=VOC_RESUME_STEPS, iters_per_checkpoint=VOC_STEPS,
        profile_dir=os.path.join(work, "profile"),
        profile_start_step=VOC_PROFILED_FROM, profile_n_steps=VOC_PROFILED)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    s2 = tr2.stats
    rows = _metrics_rows(run_dir)
    if f"resumed vocoder training from step {VOC_STEPS}" not in out2 \
            or tr2.step != VOC_RESUME_STEPS:
        fail(f"the second vocoder-fit did not resume from step {VOC_STEPS} "
             f"to {VOC_RESUME_STEPS} (at {tr2.step})")
    if [r["step"] for r in rows] != list(range(1, VOC_RESUME_STEPS + 1)) \
            or not all(math.isfinite(v) for r in rows for v in r.values()):
        fail(f"vocoder metrics.jsonl: steps {[r['step'] for r in rows]}, "
             "or a non-finite value")
    restored = CheckpointManager(os.path.join(run_dir, "ckpt")).load_payload(
        VOC_STEPS)[0]["gen"]
    if any(not torch.equal(restored[k], v) for k, v in saved.items()):
        fail("the step-6 checkpoint does not hold the first run's generator")
    log(f"[vocoder] HiFi-GAN v1: generator {n_params['gen'] / 1e6:.2f} M, "
        f"MPD {n_params['mpd'] / 1e6:.2f} M, MSD {n_params['msd'] / 1e6:.2f}"
        f" M parameters; batch {VOC_B} x {tr2.cfg.segment_size} samples")
    log("[vocoder] losses by step: " + "; ".join(
        f"{r['step']}: D {r['vocoder/disc_loss']:.4f} G "
        f"{r['vocoder/gen_loss']:.4f} mel {r['vocoder/gen_mel']:.4f}"
        for r in rows) + f" (steps {VOC_STEPS + 1}-{VOC_RESUME_STEPS} "
        f"after the resume)")
    # steps 2 to VOC_STEPS: the first warms up, the resumed run's first
    # loads cold and its last two are profiled
    walls = _walls(s1) + _walls(s2)
    steady = walls[1:VOC_STEPS]
    audio_s = VOC_B * tr2.cfg.segment_size / FIT_SR
    mean = sum(steady) / len(steady)
    log(f"[vocoder] ({card}) steps 2-{VOC_RESUME_STEPS}: "
        f"{', '.join(f'{1e3 * w:.1f}' for w in walls[1:])} ms (loader, "
        f"segments and logging in; {VOC_PROFILED_FROM + 1}-"
        f"{VOC_RESUME_STEPS} profiled), steps 2-{VOC_STEPS} mean {1e3 * mean:.2f} ms a step, "
        f"{audio_s / mean:.1f} s of {FIT_SR} Hz audio trained a second; "
        f"peak memory {peak_gib:.2f} GiB; checkpoint save "
        f"{s1['ckpt_save_s']:.2f} s of {s1['ckpt_bytes'] / 1e6:.1f} MB, "
        f"restore {s2['restore_s']:.2f} s of the same file; fit wall "
        f"{fit_s:.2f} s, resume "
        f"{resume_s:.2f} s")
    busy, wall = s2.get("profile_busy_s"), s2.get("profile_wall_s")
    if not busy:
        fail("the vocoder profile saw no device time")
    log(f"[vocoder] ({card}) profiled steps {VOC_PROFILED_FROM + 1}-"
        f"{VOC_RESUME_STEPS} (replays): wall {1e3 * wall:.1f} ms, device busy "
        f"{1e3 * busy:.1f} ms ({100 * busy / wall:.1f}%; kernel time summed "
        f"{1e3 * s2['profile_kernel_s']:.1f} ms); top kernels (ms summed "
        "over the window): " + "; ".join(
            f"{name[:60]} {ms:.2f}" for name, ms in s2["profile_top_ms"]))

    log(f"[vocoder] the graphed steps: {s1['graphed_steps']} of "
        f"{VOC_STEPS} replayed a graph in the first run (warm-ups "
        f"{s1['warmups']}, captures {s1['captures']}, replays "
        f"{s1['replays']}), {s2['graphed_steps']} of "
        f"{VOC_RESUME_STEPS - VOC_STEPS} in the resumed one")
    # every step but the first (the warm-up) replays, the second right
    # after its capture
    if s1["graphed_steps"] != VOC_STEPS - 1 or s1["warmups"] != 1:
        fail(f"vocoder-fit: {s1['graphed_steps']} graphed steps of "
             f"{VOC_STEPS}, {s1['warmups']} warm-ups")
    del tr2
    with _EagerVocoders():
        e_tr, _, e_s = _vocoder_fit(base, os.path.join(work, "hifigan_eager"),
                                    f"vocoder-fit to {VOC_STEPS}, eager",
                                    max_steps=VOC_STEPS,
                                    iters_per_checkpoint=VOC_STEPS)
    if e_tr.stats["graphed_steps"] or e_tr.stats["replays"]:
        fail("the eager vocoder-fit replayed a graph")
    g_walls, e_walls = _walls(s1)[2:], _walls(e_tr.stats)[2:]
    log(f"[vocoder] ({card}) vocoder-fit's loop, steps 3-{VOC_STEPS} "
        f"(loader, crops and logging in): graphed "
        f"{', '.join(f'{1e3 * w:.1f}' for w in g_walls)} ms, mean "
        f"{1e3 * np.mean(g_walls):.2f}; eager "
        f"{', '.join(f'{1e3 * w:.1f}' for w in e_walls)} ms, mean "
        f"{1e3 * np.mean(e_walls):.2f}; fit wall {fit_s:.2f} s graphed, "
        f"{e_s:.2f} s eager")
    del e_tr
    _vocoder_pair("hifigan", seed, card)
    torch.cuda.empty_cache()

    wg_dir = os.path.join(work, "waveglow")
    torch.cuda.reset_peak_memory_stats()
    wg, _, wg_s = _vocoder_fit(base, wg_dir, f"WaveGlow vocoder-fit to "
                               f"{VOC_WG_STEPS}", vocoder_type="waveglow",
                               max_steps=VOC_WG_STEPS,
                               iters_per_checkpoint=VOC_WG_STEPS)
    wg_walls = _walls(wg.stats)
    wg_rows = _metrics_rows(wg_dir)
    if [r["step"] for r in wg_rows] != list(range(1, VOC_WG_STEPS + 1)) \
            or not all(math.isfinite(r["vocoder/nll"]) for r in wg_rows):
        fail(f"WaveGlow metrics.jsonl: {wg_rows}")
    nll = ", ".join(f"{r['vocoder/nll']:.4f}" for r in wg_rows)
    wg_params = sum(p.numel() for p in wg.model.parameters())
    log(f"[vocoder] ({card}) WaveGlow() ({wg_params / 1e6:.2f} M "
        f"parameters), batch {VOC_B} x {wg.cfg.segment_size}: steps "
        f"{', '.join(f'{1e3 * w:.1f}' for w in wg_walls)} ms, NLL {nll}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        f"GiB; wall {wg_s:.2f} s; {wg.stats['graphed_steps']} of "
        f"{VOC_WG_STEPS} steps replayed a graph")
    if wg.stats["graphed_steps"] != VOC_WG_STEPS - 1:
        fail(f"WaveGlow vocoder-fit: {wg.stats['graphed_steps']} graphed "
             f"steps of {VOC_WG_STEPS}")
    del wg
    with _EagerVocoders():
        e_wg, _, e_s = _vocoder_fit(
            base, os.path.join(work, "waveglow_eager"),
            f"WaveGlow vocoder-fit to {VOC_WG_STEPS}, eager",
            vocoder_type="waveglow", max_steps=VOC_WG_STEPS,
            iters_per_checkpoint=VOC_WG_STEPS)
    e_walls = _walls(e_wg.stats)
    log(f"[vocoder] ({card}) WaveGlow vocoder-fit's loop, steps 3-"
        f"{VOC_WG_STEPS}: graphed "
        f"{', '.join(f'{1e3 * w:.1f}' for w in wg_walls[2:])} ms, eager "
        f"{', '.join(f'{1e3 * w:.1f}' for w in e_walls[2:])} ms; fit wall "
        f"{wg_s:.2f} s graphed, {e_s:.2f} s eager")
    del e_wg
    _vocoder_pair("waveglow", seed, card)
    torch.cuda.empty_cache()

    # vocoding: the trained HiFi-GAN from its run dir, with its Denoiser
    _cufft_c2r_check()
    g = torch.Generator().manual_seed(seed)
    mels = (torch.randn(VOC_MELS + (80,), generator=g) * 1.5 - 5.0).cuda()
    fn, den = get_vocoder("hifigan", vocoder_checkpoint_path=run_dir)
    cfn, cden = get_vocoder("hifigan", vocoder_checkpoint_path=run_dir,
                            device="cpu")
    _vocode_check("HiFi-GAN v1 (vocoder-fit run dir)", fn, den, cfn, cden,
                  mels, VOC_MELS[1])
    torch.manual_seed(seed)
    ist = Generator(HiFiGANConfig(**ISTFTNET))
    fn, den = hifigan_fns(copy.deepcopy(ist), True, torch.device("cuda"))
    cfn, cden = hifigan_fns(ist, True, torch.device("cpu"))
    _vocode_check("iSTFTNet C8C8I (random weights)", fn, den, cfn, cden,
                  mels, VOC_MELS[1])
    wg_path, wg_cfg = write_waveglow_file(work, seed)
    wfn, wden = get_vocoder("waveglow", wg_cfg, wg_path)
    cwfn, cwden = get_vocoder("waveglow", wg_cfg, wg_path, device="cpu")
    _vocode_check(
        "WaveGlow file at sigma 0 (random weights)",
        lambda m: wfn(m, sigma=0.0), wden, lambda m: cwfn(m, sigma=0.0),
        cwden, mels, WG_CPU_FRAMES, graphed_fn=wfn)
    launches = _counters()
    if any(launches.values()):
        fail(f"kernels launched on the vocoder path, which runs none: "
             f"{launches}")
    return {"run_dir": run_dir, "launches": launches}


# the ddp phase: two ranks of the flagship step against one rank on their
# concatenated batch, then fit --distributed under torchrun
DDP_B, DDP_STEPS = 8, 3
DDP_CHILD_TIMEOUT = 420
DDP_FIT_TIMEOUT = 600
DDP_FIT_STEPS, DDP_RESUME_STEPS = 3, 5
# copies of one filelist line per corpus in the fit part's corpus
DDP_FIT_LINES = 16
# the whitening init's mean and covariance, two ranks against one: f32
# sums over 3,000-odd frames in another order
WHITEN_RTOL = 1e-4


def ddp_batch(seed: int, device="cpu") -> dict:
    """The ddp phase's global batch: 2 x DDP_B items at T_text 96 and
    T_mel 512 with ragged lengths, so its two halves hold different
    numbers of valid frames."""
    rng = np.random.default_rng(seed + 7)
    B = 2 * DDP_B
    text = rng.integers(48, TRAIN_T_TEXT + 1, B)
    mel = rng.integers(256, TRAIN_T_MEL + 1, B)
    text[0], mel[0] = TRAIN_T_TEXT, TRAIN_T_MEL
    return train_batch(seed + 8, B, TRAIN_T_TEXT, TRAIN_T_MEL, device,
                       text_lens=text.tolist(), mel_lens=mel.tolist())


def _whitening_moments(model, batch):
    """(mean, covariance) the whitening init fits to ``batch`` (the global
    batch's under a data mesh)."""
    from radmmm_torch.models.flow_decoder import squeeze_time
    from radmmm_torch.models.tts import mel_scale
    from radmmm_torch.ops.invertible import whitening_stats
    from radmmm_torch.utils.masking import SeqLens
    g = model.config.decoder.get("n_group_size", 1)
    mel = mel_scale(batch["mel"]) if model.config.scale_mel else batch["mel"]
    lens = SeqLens.create(batch["output_lengths"], mel.shape[1])
    with torch.no_grad():
        return whitening_stats(squeeze_time(mel, g),
                               lens.downsample(g).mask)


def ddp_train(seed: int, batch: dict, n_steps: int, mesh) -> dict:
    """The full-width model from ``seed`` (dropout off) on the card, laid
    out on ``mesh`` (the active one): the whitening init's moments and the
    init, one step (its metrics and every gradient, gathered), then
    ``n_steps`` timed steps with the kernels' counts from zero, each with
    its gradient all-reduce timed; the parameters' checksums after."""
    from radmmm_torch.models.tts import TTSModel
    from radmmm_torch.parallel import mesh as M
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_step,
                                            make_whitening_init)
    torch.manual_seed(seed)
    model = TTSModel(no_dropout_config())
    _nudge_couplings(model)
    state = create_train_state(model, device=batch["mel"].device)
    M.shard_state(state, mesh)
    out = {"split": sorted(mesh.layout)}
    if out["split"]:
        out["tp_layout"] = M.assert_tp_layout(model, mesh,
                                              min_sharded=len(out["split"]))
    out["wn_launches"] = _wn_launches(model, True)
    out["whiten"] = [t.cpu() for t in _whitening_moments(model, batch)]
    make_whitening_init(model)(state, batch)
    step = make_train_step(model, _loss_config(), binarize=True, kl_on=True)
    gen = torch.Generator(device=batch["mel"].device)
    state, met = step(state, batch, gen)
    out["metrics"] = {k: v.item() for k, v in met.items()}
    out["grads"] = {n: mesh.gather_param(n, p.grad).cpu()
                    for n, p in model.named_parameters()}
    mesh.timed = True
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts from zero, the timed steps, counts read after
    _zero_counters()
    M.reset_collective_stats()
    out["ms"], out["sync"] = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, met = step(state, batch, gen)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["sync"].append(mesh.last_grad_sync)
        bad = [k for k, v in met.items() if not math.isfinite(v.item())]
        if bad:
            raise FloatingPointError(f"non-finite {bad}")
    out["launches"] = _counters()
    out["collectives"] = M.collective_stats()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["sums"] = {n: int(p.detach().view(torch.int32).long().sum())
                   for n, p in model.named_parameters()}
    return out


def ddp_child(spec_path: str, rank: int) -> int:
    """One rank of part (a) or (b): joins the group the spec names (its
    backend, world and port; ranks beyond the cards share them), runs
    ``ddp_train`` on its data rank's half of the global batch and writes
    its results (rank 0's with the gradients) for the parent."""
    import os
    import torch.distributed as dist
    from radmmm_torch.parallel import mesh as M
    with open(spec_path) as f:
        spec = json.load(f)
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(spec["backend"],
                            init_method=f"tcp://127.0.0.1:{spec['port']}",
                            rank=rank, world_size=spec["world"])
    m = M.make_mesh(spec["n_data"], spec["n_model"])
    batch = ddp_batch(spec["seed"], dev)
    n = len(batch["text"]) // spec["n_data"]
    if spec["n_model"] > 1:
        n = DDP_B                     # TP: each rank the first half
    mine = {k: v[m.data_index * n:(m.data_index + 1) * n]
            for k, v in batch.items()}
    if spec["probe"]:
        spec["gloo_cuda"] = _gloo_cuda_probe(dev, rank)
    with M.use_mesh(m):
        out = ddp_train(spec["seed"], mine, DDP_STEPS, m)
    out.update(rank=rank, device=str(dev), frames=int(
        mine["output_lengths"].sum()), gloo_cuda=spec.get("gloo_cuda"))
    if rank:
        out.pop("grads")
    torch.save(out, os.path.join(spec["work"], f"{spec['part']}_{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _gloo_cuda_probe(dev, rank: int):
    """Which collectives gloo takes on CUDA tensors: each asked of both
    ranks at once (gloo refuses an op before it talks, alike on both; a
    hang would meet the child's timeout). The answers on rank 0, None on
    the other."""
    import torch.distributed as dist
    x = torch.ones(4, device=dev)
    two = torch.ones(8, device=dev)
    calls = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x), torch.empty_like(x)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty_like(two), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty_like(x), two),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = True
        except (RuntimeError, NotImplementedError, ValueError) as e:
            out[name] = str(e).splitlines()[0][:80]
    return out if rank == 0 else None


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(cmds, timeout: float, what: str) -> list:
    """Run the commands at once, each under ``timeout``; any that fails or
    hangs fails the phase (the others are killed). Returns their output."""
    import subprocess
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = []
    try:
        for i, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                fail(f"{what}: process {i} did not end in {timeout} s")
            if p.returncode != 0:
                log(outs[-1][-6000:])
                fail(f"{what}: process {i} exited {p.returncode}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _nccl_one_rank(fn):
    """``fn()`` inside a one-rank NCCL group on card 0, after NCCL's
    all-gather and reduce-scatter (the port's wrappers) and an all-reduce
    ran in it once: on one card that is what NCCL can run."""
    import torch.distributed as dist
    from radmmm_torch.parallel import collectives as C
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        g = C.Group(dist.group.WORLD, 1, 0, dist.get_backend())
        x = torch.randn(3, 5, device="cuda")
        stack = C._gather_stack(x, g)
        back = C._reduce_scatter_stack(stack, g)
        y = x.clone()
        dist.all_reduce(y)
        torch.cuda.synchronize()
        if not (torch.equal(stack[0], x) and torch.equal(back, x)
                and torch.equal(y, x)):
            fail("a one-rank NCCL group changed its input")
        log(f"[ddp] NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}: "
            "a one-rank group on card 0 built, its all-gather, "
            "reduce-scatter and all-reduce returned their input")
        _nccl_graph_probe(g, x)
        return fn()
    finally:
        dist.destroy_process_group()


def _nccl_graph_probe(g, x) -> None:
    """The one-rank NCCL group's all-gather, reduce-scatter and all-reduce
    inside a CUDA graph (``utils/graphs.Graphed``, as the trainer's steps
    hold them over NCCL), called three times: a warm-up, a capture and a
    replay, then a replay; each result equal to the eager call's, and the
    collectives' tally three calls' worth (the ledger takes the capture's
    counts back and adds them at each replay)."""
    import torch.distributed as dist
    from radmmm_torch.parallel import collectives as C
    from radmmm_torch.utils.graphs import Graphed, GraphPool

    def fn(inputs):
        stack = C._gather_stack(inputs["x"] * 2, g)
        out = C._reduce_scatter_stack(stack, g)
        dist.all_reduce(out)
        return out + 1

    want = fn({"x": x})
    pool = GraphPool()
    graphed = Graphed(fn, pool, name="nccl_probe")
    C.reset_stats()
    got = [graphed({"x": x}) for _ in range(3)]
    torch.cuda.synchronize()
    tally = dict(C.STATS)
    C.reset_stats()
    fn({"x": x})
    once = dict(C.STATS)
    C.reset_stats()
    steps = (pool.warmups, len(pool.captures), pool.replays)
    log(f"[ddp] NCCL's all-gather, reduce-scatter and all-reduce in a CUDA "
        f"graph on the one-rank group: warm-ups, captures, replays {steps}; "
        f"equal to eager {[torch.equal(a, want) for a in got]}; collectives "
        f"counted over the three calls {tally}, one eager call {once}")
    if steps != (1, 1, 2) or not all(torch.equal(a, want) for a in got) \
            or tally != {k: 3 * v for k, v in once.items()}:
        fail("NCCL's collectives in a CUDA graph did not replay as eager, "
             "or the ledger miscounted them")


def _ddp_parts(seed: int, backend: str, work: str, refs: dict) -> dict:
    """Parts (a) and (b): two ranks as children of this process (and a
    2 x 2 mesh of four where NCCL has four cards), against the one-rank
    references. Returns the kernels' launches on rank 0's timed steps,
    summed."""
    import os
    total = dict.fromkeys(PER_STEP, 0)
    parts = [("a", 2, 1), ("b", 1, 2)]
    if backend == "nccl" and torch.cuda.device_count() >= 4:
        parts.append(("b 2x2", 2, 2))
    for part, n_data, n_model in parts:
        ref = refs["B8"] if n_data == 1 else refs["B16"]
        world = n_data * n_model
        spec = dict(part=part, seed=seed, n_data=n_data, n_model=n_model,
                    backend=backend, world=world, port=_free_port(),
                    work=work, probe=part == "a" and backend == "gloo")
        path = os.path.join(work, f"{part}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        _run_children([[sys.executable, __file__, "--ddp-child", path,
                        str(r)] for r in range(world)], DDP_CHILD_TIMEOUT,
                      f"ddp ({part})")
        res = [torch.load(os.path.join(work, f"{part}_{r}.pt"),
                          weights_only=False) for r in range(world)]
        what = {"a": "data parallel, B 8 a rank, against one rank on B 16",
                "b": "tensor parallel, n_model 2, B 8 on each rank, "
                     "against one rank on B 8",
                "b 2x2": "n_data 2 x n_model 2, B 8 a data rank, against "
                         "one rank on B 16"}[part]
        log(f"[ddp] ({part}) {what}: {world} ranks in "
            f"{time.perf_counter() - t0:.1f} s")
        _ddp_check(part, res, ref, n_model)
        for k in total:
            total[k] += res[0]["launches"][k]
    return total


def _ddp_check(part: str, res: list, ref: dict, n_model: int) -> None:
    """Every rank's numbers printed; rank 0's loss terms, gradients and
    whitening moments held against the one-rank reference; the ranks'
    metrics and parameters alike bit for bit (a split one across the
    ranks of one model index). A step's K7 launches are counted from the
    rank's own WN stacks (9 a flow where they are split)."""
    for r in res:
        per_step = {**PER_STEP, "wn_conv_fwd": 0, "wn_conv_dgrad": 0,
                    "wn_conv_wgrad": 0, **r["wn_launches"]}
        want_launches = {k: n * DDP_STEPS for k, n in per_step.items()}
        syncs = r["sync"]
        log(f"[ddp] ({part}) rank {r['rank']} on {r['device']}: "
            f"{r['frames']} valid mel frames, ms a step "
            + ", ".join(f"{ms:.1f}" for ms in r["ms"])
            + "; gradient all-reduce a step "
            + ", ".join(f"{ms:.1f} ms" for ms, _ in syncs)
            + f" of {syncs[0][1] / 1e6:.1f} MB; peak "
            f"{r['peak_gib']:.2f} GiB; collectives on {DDP_STEPS} steps "
            f"{r['collectives']}; kernel launches {r['launches']}")
        if r["launches"] != want_launches:
            fail(f"ddp ({part}) rank {r['rank']}: kernel launches "
                 f"{r['launches']}, expected {want_launches}")
        if r.get("gloo_cuda"):
            log(f"[ddp] gloo on CUDA tensors: {r['gloo_cuda']}")
    if n_model > 1:
        n = [r["tp_layout"] for r in res]
        log(f"[ddp] ({part}) assert_tp_layout passed on every rank: {n} "
            f"parameters split ({len(res[0]['split'])} by the rules)")
    got = res[0]
    worst = 0.0
    for k, want in ref["metrics"].items():
        g = got["metrics"][k]
        err = abs(g - want)
        worst = max(worst, err / (1e-5 + abs(want)))
        if not (math.isfinite(g) and err <= 1e-5 + TRAIN_PARITY_RTOL
                * abs(want)):
            fail(f"ddp ({part}): {k} {g} against one rank's {want}")
        if any(r["metrics"][k] != g for r in res):
            fail(f"ddp ({part}): the ranks logged other {k}")
    log(f"[ddp] ({part}) loss terms and grad norm, rank 0 / one rank: "
        + ", ".join(f"{k} {got['metrics'][k]!r} / {w!r}"
                    for k, w in ref["metrics"].items()))
    log(f"[ddp] ({part}) worst relative error {worst:.3e} (rtol "
        f"{TRAIN_PARITY_RTOL:g})")
    for name, g, w in zip(("mean", "covariance"), got["whiten"],
                          ref["whiten"]):
        err = (g - w).abs().max().item() / w.abs().max().item()
        log(f"[ddp] ({part}) whitening init's {name}: {err:.3e} of its "
            f"largest entry (bound {WHITEN_RTOL:g})")
        if not err <= WHITEN_RTOL:
            fail(f"ddp ({part}): the whitening init's {name} disagrees")
    errs = grad_errors(got["grads"], ref["grads"])
    log(f"[ddp] ({part}) gradients of {len(errs)} parameters against one "
        f"rank, worst: " + ", ".join(f"{e:.3e} {n}" for e, n, _ in errs[:3])
        + f" (bound {GRAD_PARITY_RTOL:g})")
    if not errs[0][0] <= GRAD_PARITY_RTOL:
        fail(f"ddp ({part}): gradients disagree on {errs[0][1]}")
    differ = sorted({n for i, r in enumerate(res) for n, v in r["sums"].items()
                     if v != res[i % n_model if n in got["split"] else 0][
                         "sums"][n]})
    log(f"[ddp] ({part}) after {DDP_STEPS + 1} steps the {len(res)} ranks' "
        f"checksums of {len(got['sums'])} parameters ({len(got['split'])} "
        f"split): {len(got['sums']) - len(differ)} alike")
    if differ:
        fail(f"ddp ({part}): the ranks' parameters differ: {differ[:5]}")


def ddp_corpus(root: str, seed: int, lines: int = DDP_FIT_LINES) -> dict:
    """The fit part's corpus: for each of FIT_SOURCES, ``lines`` copies
    of its first training line of at most FIT_MAX_S seconds (text,
    speaker, emotion and duration kept), for training and for validation,
    each with its own voiced audio. Every batch of a corpus then has one
    scheduled shape, so the loader deals whole rounds to the two ranks."""
    import os
    from scipy.io import wavfile
    rng = np.random.default_rng(seed)
    out = {"train": {}, "val": {}}
    rate = f"{FIT_SR // 1000}khz"
    for c, (name, lang, train_list, _) in enumerate(FIT_SOURCES):
        with open(train_list, encoding="utf-8") as f:
            parts = next(p for p in (line.rstrip("\n").split("|")
                                     for line in f)
                         if len(p) >= 5 and float(p[4]) <= FIT_MAX_S)
        base = os.path.join(root, name)
        os.makedirs(os.path.join(base, rate), exist_ok=True)
        for split in ("train", "val"):
            rows = []
            for j in range(lines):
                wav = f"{split}_{j}.wav"
                wavfile.write(os.path.join(base, rate, wav), FIT_SR,
                              _voiced_wav(int(float(parts[4]) * FIT_SR),
                                          100.0 + 25.0 * c + 7.0 * j, rng))
                rows.append("|".join([wav] + parts[1:]))
            filelist = os.path.join(root, f"{name}_{split}.txt")
            with open(filelist, "w", encoding="utf-8") as f:
                f.write("\n".join(rows) + "\n")
            out[split][name] = {
                "basedir": base, "sampling_rate": rate,
                "filelist_basedir": "", "filelist": filelist,
                "language": lang, "phonemized": True}
    return out


def ddp_fit_child(result_dir: str, argv: list, opts: list) -> int:
    """One rank of part (c) or of the graphs phase's part (g), started by
    torchrun: the training CLI's ``main(argv)`` with the kernels' and the
    collectives' counts from zero and each training step's launches
    recorded, then this rank's parameter checksums (gathered), logger,
    checkpoints, step walls (validation and saves out), graphed steps and
    collectives for the parent. ``opts``: "eager" runs the trainer's
    eager steps (``_EagerSteps``), "profile:N" traces step N."""
    import os
    from radmmm_torch.parallel import mesh as M
    from radmmm_torch.training import cli
    profiled = next((int(o.split(":")[1]) for o in opts
                     if o.startswith("profile:")), -1)
    records = []
    _zero_counters()
    M.reset_collective_stats()
    with _per_step(records, profiled), \
            _EagerSteps() if "eager" in opts else contextlib.nullcontext():
        _, tr = cli.main(argv)
    st = tr.stats
    out = dict(rank=int(os.environ["RANK"]), device=str(tr.device),
               launches=_counters(loaders=True), steps=[r["launches"] for r in records],
               graphed=[r["graphed"] and not r["captured"]
                        for r in records],
               profile=next((r["profile"] for r in records
                             if "profile" in r), None),
               collectives=M.collective_stats(),
               logger=tr.logger.enabled, ckpts=tr.ckpt.steps(),
               n_steps=st["steps"], mesh=tr.mesh.shape,
               walls=_step_walls(st, range(len(st["step_starts"]) - 1)),
               loader_share=st["loader_wait_s"] / max(st["train_s"], 1e-9),
               **{k: st[k] for k in ("warmups", "captures", "replays")},
               sums=[int(tr.mesh.gather_param(n, p).detach().view(
                   torch.int32).long().sum())
                   for n, p in tr.model.named_parameters()])
    with open(os.path.join(result_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    return 0


def _ddp_fit(seed: int, backend: str, work: str) -> dict:
    """Part (c): ``fit --distributed`` of the recipe at full width on two
    ranks launched by torchrun, to DDP_FIT_STEPS, then a resume to
    DDP_RESUME_STEPS. Returns rank 0's kernel launches over both runs."""
    import os
    root = os.path.join(work, "fit")
    os.makedirs(root)
    overlay = fit_overlay(root, ddp_corpus(root, seed))
    base = [a for c in RECIPE + (overlay,) for a in ("-c", c)]
    base += ["--distributed", "--trainer.log_interval=1",
             f"--trainer.val_check_interval={DDP_FIT_STEPS}",
             "--model.iters_per_checkpoint=100"]
    if backend == "gloo":
        base += ["--dist-backend", "gloo"]
    total = dict.fromkeys(FIT_STEP, 0)
    ckpt_dir = os.path.join(root, "run", "ckpt")
    rows_before = 0
    for tag, steps in (("fit", DDP_FIT_STEPS), ("resume", DDP_RESUME_STEPS)):
        res_dir = os.path.join(work, f"ranks_{tag}")
        os.makedirs(res_dir)
        argv = ["fit"] + base + [f"--trainer.max_steps={steps}"]
        log(f"[ddp] (c) python -m torch.distributed.run --standalone "
            f"--nproc-per-node 2 chip_smoke.py --ddp-fit-child DIR -- "
            f"{' '.join(argv)} (each rank: radmmm_torch.training.cli.main)")
        t0 = time.perf_counter()
        (out,) = _run_children([[
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", __file__, "--ddp-fit-child", res_dir,
            "--"] + argv], DDP_FIT_TIMEOUT, f"ddp (c) {tag}")
        wall = time.perf_counter() - t0
        res = [json.load(open(os.path.join(res_dir, f"rank{r}.json")))
               for r in range(2)]
        saved = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
        rows = _metrics_rows(os.path.join(root, "run"))
        train = [r["step"] for r in rows[rows_before:] if "train/loss" in r]
        rows_before = len(rows)
        for r in res:
            log(f"[ddp] (c) {tag}: rank {r['rank']} on {r['device']}, mesh "
                f"{r['mesh']}, {r['n_steps']} steps ({sum(r['graphed'])} "
                f"replayed a graph captured earlier), ms a step (start to "
                f"next start, validation and saves out) "
                + ", ".join(f"{w:.1f}" for w in r["walls"])
                + f", logger {'on' if r['logger'] else 'off'}, checkpoints "
                f"{r['ckpts']}, kernel launches {r['launches']}")
        log(f"[ddp] (c) {tag} in {wall:.1f} s: checkpoints on disk {saved}, "
            f"metrics.jsonl train rows for steps {train}")
        first = DDP_FIT_STEPS if tag == "resume" else 0
        bad = [r for r in rows for k, v in r.items()
               if k != "step" and "loss" in k and not math.isfinite(v)]
        if (saved != sorted({DDP_FIT_STEPS, steps})
                or train != list(range(first + 1, steps + 1)) or bad):
            fail(f"ddp (c) {tag}: checkpoints {saved}, logged steps {train}"
                 f", non-finite rows {bad[:2]}")
        if [r["logger"] for r in res] != [True, False]:
            fail(f"ddp (c) {tag}: only rank 0 should log")
        if res[0]["sums"] != res[1]["sums"]:
            fail(f"ddp (c) {tag}: the ranks' parameters differ")
        if tag == "resume" and out.count(
                f"resumed from step {DDP_FIT_STEPS}") != 2:
            fail("ddp (c): both ranks should resume from step "
                 f"{DDP_FIT_STEPS}")
        for i, got in enumerate(res[0]["steps"]):
            want = dict(FIT_STEP)
            if first + i < FIT_BINARIZE_FROM:
                want["mas_width1"] = 0
            if got != want:
                fail(f"ddp (c) {tag}: step {first + i + 1} launched {got}, "
                     f"expected {want}")
        for k in total:
            total[k] += res[0]["launches"][k]
    log(f"[ddp] (c) both ranks' parameters bit for bit alike after each "
        f"run; one writer of metrics.jsonl; the resume went on from step "
        f"{DDP_FIT_STEPS}")
    return total


# the ddp phase's part (d): the E2E-GAN decoder's STFT loss (five
# resolutions, A-weighted) on two data ranks against one rank on their
# concatenated batch: E2E_B items of up to E2E_SECONDS of 22,050 Hz audio,
# the longest on rank 1 only. Each rank's terms are its share of the
# global loss, so they sum to one rank's; its audio_hat gradient is its
# rows of one rank's (NaN where a masked frame's zero sum meets the
# spectral convergence's sqrt, in both). The split changes only the order
# of the global normalisers' and the loss's sums: rtol 1e-5, the gradient
# with a floor of 1e-6 of its largest magnitude
E2E_B, E2E_SECONDS, E2E_T_TEXT = 4, 2.0, 64
E2E_RTOL = 1e-5


def e2e_batch(seed: int, device) -> dict:
    """Part (d)'s global batch: audio, audio_hat, lengths (the longest,
    item 2, on rank 1), and a soft alignment for the CTC term."""
    rng = np.random.default_rng(seed + 21)
    T = int(E2E_SECONDS * SR)
    lens = np.asarray([int(T * 0.8), int(T * 0.6), T, int(T * 0.45)])
    T_mel = -(-T // HOP)
    attn = rng.uniform(0.01, 1, (E2E_B, T_mel, E2E_T_TEXT)).astype(
        np.float32)
    attn /= attn.sum(-1, keepdims=True)
    arrays = dict(
        audio=(rng.standard_normal((E2E_B, T)) * 0.1).astype(np.float32),
        audio_hat=(rng.standard_normal((E2E_B, T)) * 0.1).astype(np.float32),
        audio_lens=lens.astype(np.float32),
        mel_lens=(-(-lens // HOP)).astype(np.int32),
        text_lens=rng.integers(E2E_T_TEXT // 2, E2E_T_TEXT + 1,
                               E2E_B).astype(np.int32), attn=attn)
    return {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}


def e2e_loss(batch: dict) -> tuple:
    """RADTTSE2EGANLoss on ``batch`` under the current mesh, binarization
    on: ({term: value}, the gradient of the weighted sum in audio_hat)."""
    from radmmm_torch.losses.flow import RADTTSE2EGANLoss
    from radmmm_torch.utils.masking import SeqLens
    audio_hat = batch["audio_hat"].clone().requires_grad_()
    attn = batch["attn"]
    out = {"audio_hat": audio_hat, "attn": attn, "attn_soft": attn,
           "attn_logprob": attn.log()}
    terms = RADTTSE2EGANLoss()(
        out, batch["audio"], batch["audio_lens"],
        SeqLens.create(batch["text_lens"], attn.shape[-1]),
        SeqLens.create(batch["mel_lens"], attn.shape[-2]), True)
    sum(v * w for v, w in terms.values()).backward()
    return ({k: v.item() for k, (v, _) in terms.items()},
            audio_hat.grad.cpu())


def e2e_child(spec_path: str, rank: int) -> int:
    """One rank of part (d): its half of the global batch on its card (or
    the CPU, where the spec says so) under a (2, 1) mesh."""
    import os
    import torch.distributed as dist
    from radmmm_torch.parallel import mesh as M
    with open(spec_path) as f:
        spec = json.load(f)
    if spec["device"] == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(spec["backend"],
                            init_method=f"tcp://127.0.0.1:{spec['port']}",
                            rank=rank, world_size=2)
    half = E2E_B // 2
    mine = {k: v[rank * half:(rank + 1) * half]
            for k, v in e2e_batch(spec["seed"], dev).items()}
    with M.use_mesh(M.make_mesh(2, 1)):
        terms, grad = e2e_loss(mine)
    torch.save(dict(terms=terms, grad=grad),
               os.path.join(spec["work"], f"e2e_{rank}.pt"))
    dist.destroy_process_group()
    return 0


def _ddp_e2e(seed: int, backend: str, work: str, device: str = "cuda"
             ) -> None:
    """Part (d): two ranks as children against one rank here."""
    import os
    t0 = time.perf_counter()
    terms, grad = e2e_loss(e2e_batch(seed, torch.device(device)))
    spec = dict(seed=seed, backend=backend, port=_free_port(), work=work,
                device=device)
    path = os.path.join(work, "e2e.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    _run_children([[sys.executable, __file__, "--e2e-child", path, str(r)]
                   for r in range(2)], DDP_CHILD_TIMEOUT, "ddp (d)")
    res = [torch.load(os.path.join(work, f"e2e_{r}.pt"), weights_only=False)
           for r in range(2)]
    worst = 0.0
    for k, want in terms.items():
        got = res[0]["terms"][k] + res[1]["terms"][k]
        err = abs(got - want) / max(abs(want), 1e-12)
        worst = max(worst, err)
        log(f"[ddp] (d)   {k}: ranks {res[0]['terms'][k]:.6f} + "
            f"{res[1]['terms'][k]:.6f} = {got:.6f}, one rank {want:.6f}")
    got = torch.cat([r["grad"] for r in res])
    nan = torch.isnan(grad)
    same_nan = bool(torch.equal(nan, torch.isnan(got)))
    fin = ~nan
    top = grad[fin].abs().max().item()
    diff = (got[fin] - grad[fin]).abs()
    g_ok = bool((diff <= E2E_RTOL * grad[fin].abs() + 1e-6 * top).all())
    log(f"[ddp] (d) the E2E-GAN loss on two data ranks (B {E2E_B // 2} each, "
        f"{backend}) against one rank on B {E2E_B} in "
        f"{time.perf_counter() - t0:.1f} s: loss terms worst relative "
        f"{worst:.3e}; audio_hat gradient worst difference "
        f"{diff.max().item() / top:.3e} of its largest magnitude (rtol "
        f"{E2E_RTOL:g} with a floor of 1e-6 of it: {g_ok}); NaN at the "
        f"same {int(nan.sum())} of {nan.numel()} samples: {same_nan}")
    if not (worst <= E2E_RTOL and g_ok and same_nan):
        fail("ddp (d): the E2E-GAN loss over two ranks is not one rank's")


def phase_ddp(seed: int) -> dict:
    """Training on two ranks: (a) data parallel and (b) tensor parallel
    against one rank, (d) the E2E-GAN decoder's STFT loss on two data
    ranks against one, (c) fit --distributed with a resume. Returns the
    kernels' launches on rank 0's counted steps of (a)-(c)."""
    import os
    from radmmm_torch.parallel.mesh import Mesh
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 2 else "gloo"
    log(f"[ddp] {n_cards} card(s), PyTorch {torch.__version__}, CUDA "
        f"{torch.version.cuda}: backend {backend}, world size 2"
        + (" (both ranks on card 0 over gloo: CUDA tensors through host "
           "memory, which proves the arithmetic, not NCCL's bandwidth)"
           if backend == "gloo" else ", a card a rank"))
    t0 = time.perf_counter()
    batch = ddp_batch(seed, torch.device("cuda"))
    half = {k: v[:DDP_B] for k, v in batch.items()}

    def references():
        with tf32_off():
            return {"B16": ddp_train(seed, batch, 0, Mesh(1, 1)),
                    "B8": ddp_train(seed, half, 0, Mesh(1, 1))}

    refs = _nccl_one_rank(references)
    del batch, half
    torch.cuda.empty_cache()
    log(f"[ddp] one-rank references (B 16 and B 8) in "
        f"{time.perf_counter() - t0:.1f} s")
    work = tempfile.mkdtemp(prefix="radmmm_ddp_")
    try:
        total = _ddp_parts(seed, backend, work, refs)
        _ddp_e2e(seed, backend, work)
        fit = _ddp_fit(seed, backend, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"[ddp] phase in {time.perf_counter() - t0:.1f} s")
    return {k: total[k] + fit[k] for k in fit}


# the graphs phase: the JAX package's compiled programs as CUDA graphs
GRAPH_K = 8
# how much larger a trainer's pool of two graphs may be than the larger
# graph captured alone: the second capture reuses the first's
# intermediates (the pool's one stream) and adds its static outputs, a
# few allocator segments (2 or 20 MiB each)
GRAPH_SHARED_POOL_SLACK = 64 * 2**20
GRAPH_NOISE = 0.01      # mel noise, so the noise input is exercised
GRAPH_REQUESTS = 20
GRAPH_TEXT_BUCKETS = [(1, 96), (4, 96)]
# runtime calls that queue work on the card, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")


def host_profile(fn) -> dict:
    """torch.profiler over one call of ``fn`` (after one untraced call):
    see ``traced``."""
    fn()
    torch.cuda.synchronize()
    return traced(fn)[1]


def traced(fn) -> tuple:
    """torch.profiler over one call of ``fn``, the card synchronised
    before and after: (its result, {the wall ms, the card's busy ms, its
    kernels and the host's launch calls (kernels, graphs, copies and fills
    queued), and ``union_ms``, the union of the kernels' intervals (the
    card's busy time where kernels overlap, as a graph's may)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from radmmm_torch.utils.graphs import no_capture
    from radmmm_torch.utils.profiling import union_length
    # no loader's thread captures while the card is synchronised and the
    # profiler starts and stops
    with no_capture():
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA
           and e.device_time_total > 0]
    host = {e.key: e.count for e in ev if e.device_type == DeviceType.CPU
            and e.key.startswith(HOST_LAUNCH_CALLS)}
    union = union_length((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False)
                         ) / 1e3
    return out, dict(wall_ms=wall, union_ms=union,
                     busy_ms=sum(e.device_time_total for e in dev) / 1e3,
                     kernels=sum(e.count for e in dev),
                     host_launches=sum(host.values()), host_calls=host)


def _graph_raws(seed: int, feat, dev) -> dict:
    """GRAPH_K raw batches of featurize_items' eight utterances (each
    step's audio rolled by another offset), stacked on the card."""
    from radmmm_torch.data.collate import collate_host
    from radmmm_torch.training.step import stack_raw_batches
    raw = feat.raw_arrays(collate_host(featurize_items(seed)))
    raws = [dict(raw, audio_i16=np.roll(raw["audio_i16"], 997 * i, axis=1))
            for i in range(GRAPH_K)]
    return {k: torch.from_numpy(a).to(dev)
            for k, a in stack_raw_batches(raws).items()}


def _max_diff(got: list, want: list) -> float:
    return max(float((a.detach().double() - b.detach().double()).abs()
                     .max()) for a, b in zip(got, want))


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN restricted to deterministic algorithms inside
    (torch.backends.cudnn.deterministic); the previous setting after."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def _graphs_train(seed: int, tag: str) -> dict:
    """Part (a) at the conv precision set. Equality, with cuDNN's
    deterministic algorithms (its default f32 algorithms sum in an order
    that changes from run to run, so two eager runs differ): 2 x GRAPH_K
    flagship steps (binarize and KL on, B 8, T_text 96, T_mel 512,
    featurized from int16 audio with mel noise) through
    make_train_megastep, graphed, from the same model, batches and
    generators as 2 x GRAPH_K eager featurize_raw + make_train_step steps,
    twice (the second eager run shows the eager path repeats itself):
    every metric, every parameter and the dropout generator bit for bit,
    and the launch ledger's counts. RAdam's plain branch (steps 1-5) and
    its rectified branch (from 6) each capture a graph. Then the time, at
    cuDNN's default algorithms: a graph captured anew, GRAPH_K graphed and
    GRAPH_K eager steps, ms a step over the next GRAPH_K each way, one step
    each profiled (busy, kernels, the host's launch calls), capture
    seconds, the pool's bytes and peak memory. Returns the graphed
    equality run's launches."""
    from radmmm_torch.data.collate import Featurizer
    from radmmm_torch.models.tts import TTSModel, default_radmmm_config
    from radmmm_torch.training.step import (create_train_state,
                                            make_train_megastep,
                                            make_train_step,
                                            make_whitening_init)
    from radmmm_torch.utils.graphs import GraphPool
    dev = torch.device("cuda")
    feat = Featurizer(device="cuda", mel_noise_scale=GRAPH_NOISE)
    stacked = _graph_raws(seed, feat, dev)
    first = feat.featurize_raw({k: v[0] for k, v in stacked.items()},
                               feat.noise_key_for_step(0))
    torch.manual_seed(seed)
    base = TTSModel(default_radmmm_config())
    _nudge_couplings(base)
    states = []
    for i in range(3):
        st = create_train_state(copy.deepcopy(base) if i < 2 else base,
                                device="cuda")
        make_whitening_init(st.model)(st, first)
        states.append(st)
    del base
    loss = _loss_config()
    gens = [torch.Generator(device=dev).manual_seed(seed) for _ in states]
    eager_fns = [make_train_step(st.model, loss, True, True)
                 for st in states]

    def eager_steps(i: int, n: int) -> list:
        rows = []
        for j in range(n):
            raw = {k: v[j % GRAPH_K] for k, v in stacked.items()}
            batch = feat.featurize_raw(raw, feat.noise_key_for_step(
                states[i].step))
            states[i], m = eager_fns[i](states[i], batch, gens[i])
            rows.append(m)
        return rows

    with cudnn_deterministic():
        pool = GraphPool()
        mega = make_train_megastep(states[0].model, loss, feat, True, True,
                                   pool=pool)
        _zero_counters()
        g_met = [mega(states[0], stacked, gens[0])[1] for _ in range(2)]
        launches = _counters()
        e_met = [eager_steps(i, 2 * GRAPH_K) for i in (1, 2)]
        torch.cuda.synchronize()
    # each graphed step featurizes its raw batch with pYIN inside the graph
    want = {k: n * 2 * GRAPH_K for k, n in dict(
        PER_STEP_BF16 if tag == "bf16" else PER_STEP,
        pyin_viterbi=1).items()}
    log(f"[graphs] ({tag}) graphed: kernel launches on {2 * GRAPH_K} steps "
        f"{launches} (expected {want})")
    if launches != want:
        fail(f"({tag}) the graphed steps did not launch each kernel as "
             "expected (the launch ledger)")
    if len(pool.captures) != 2:
        fail(f"({tag}) expected 2 captures (RAdam's two branches), got "
             f"{len(pool.captures)}")
    names = list(e_met[0][0])
    graph_rows = [{n: torch.cat([m[n] for m in g_met])[i] for n in names}
                  for i in range(2 * GRAPH_K)]
    bad = [(i, n) for i, r in enumerate(graph_rows) for n, v in r.items()
           if not math.isfinite(v.item())]
    if bad:
        fail(f"({tag}) non-finite graphed metrics {bad[:4]}")
    params = [list(st.model.parameters()) for st in states]

    def diffs(a_rows, b_rows, a_params, b_params):
        met = max(abs(a[n].item() - b[n].item()) for a, b in
                  zip(a_rows, b_rows) for n in names)
        equal = (all(torch.equal(a[n], b[n]) for a, b in zip(a_rows, b_rows)
                     for n in names)
                 and all(torch.equal(a, b) for a, b in zip(a_params,
                                                           b_params)))
        return met, _max_diff(a_params, b_params), equal

    g_e = diffs(graph_rows, e_met[0], params[0], params[1])
    e_e = diffs(e_met[1], e_met[0], params[2], params[1])
    gen_equal = torch.equal(gens[0].get_state(), gens[1].get_state())
    log(f"[graphs] ({tag}) deterministic cuDNN, graphed against eager after "
        f"{2 * GRAPH_K} steps: metrics max |diff| {g_e[0]:.3e}, parameters "
        f"{g_e[1]:.3e}, bit-equal {g_e[2]}; eager against eager: "
        f"{e_e[0]:.3e}, {e_e[1]:.3e}, bit-equal {e_e[2]}; dropout "
        f"generators alike {gen_equal}")
    log(f"[graphs] ({tag}) loss by step, graphed: " + ", ".join(
        f"{r['loss'].item():.6f}" for r in graph_rows))
    if not (g_e[2] and e_e[2] and gen_equal):
        fail(f"({tag}) the graphed steps are not bit-equal to the eager "
             "steps")
    if pool.warmups != 2 or pool.replays != 2 * GRAPH_K - 2:
        fail(f"({tag}) expected 2 warm-ups and {2 * GRAPH_K - 2} replays, "
             f"got {pool.warmups} and {pool.replays}")
    for c in pool.captures:
        log(f"[graphs] ({tag}) deterministic capture of {c.name} (RAdam "
            f"rectified {c.signature[0][0]}): {c.seconds:.3f} s, pool "
            f"+{c.pool_bytes / 2**20:.1f} MiB, launches a replay "
            f"{c.launches}")
    # the rectified branch holds one more parameter-sized list at the
    # update, so it is the larger graph: captured alone into a pool of its
    # own (two more steps of states[0], a warm-up and a capture), it
    # bounds what the shared pool may hold
    solo = GraphPool()
    with cudnn_deterministic():
        make_train_megastep(states[0].model, loss, feat, True, True,
                            pool=solo)(
            states[0], {k: v[:2] for k, v in stacked.items()}, gens[0])
    (alone,) = solo.captures
    shared = sum(c.pool_bytes for c in pool.captures)
    log(f"[graphs] ({tag}) the shared pool of both captures "
        f"{shared / 2**20:.1f} MiB; the rectified graph alone in a pool of "
        f"its own +{alone.pool_bytes / 2**20:.1f} MiB")
    if shared > alone.pool_bytes + GRAPH_SHARED_POOL_SLACK:
        fail(f"({tag}) the two captures' shared pool is larger than the "
             f"larger graph's own by over "
             f"{GRAPH_SHARED_POOL_SLACK / 2**20:.0f} MiB: the second did "
             "not reuse the first's memory")
    del solo
    del pool, mega, e_met, g_met, graph_rows
    torch.cuda.empty_cache()

    # the time, at cuDNN's default algorithms: a new capture
    pool = GraphPool()
    mega = make_train_megastep(states[0].model, loss, feat, True, True,
                               pool=pool)
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for group in range(2):
        t0 = time.perf_counter()
        mega(states[0], stacked, gens[0])
        torch.cuda.synchronize()
        out[f"graph_{group}"] = 1e3 * (time.perf_counter() - t0) / GRAPH_K
    g_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for group in range(2):
        t0 = time.perf_counter()
        eager_steps(1, GRAPH_K)
        torch.cuda.synchronize()
        out[f"eager_{group}"] = 1e3 * (time.perf_counter() - t0) / GRAPH_K
    e_peak = torch.cuda.max_memory_allocated()
    (c,) = pool.captures
    gp = host_profile(lambda: mega(
        states[0], {k: v[:1] for k, v in stacked.items()}, gens[0]))
    ep = host_profile(lambda: eager_steps(1, 1))
    for name, p in (("graphed", gp), ("eager", ep)):
        log(f"[graphs] ({tag}) one {name} featurize + step, traced: wall "
            f"{p['wall_ms']:.2f} ms, busy {p['busy_ms']:.2f} ms "
            f"({100 * p['busy_ms'] / p['wall_ms']:.1f}%), {p['kernels']} "
            f"kernels, {p['host_launches']} host launch calls "
            f"{p['host_calls']}")
    log(f"[graphs] ({tag}) ms a step (featurize + step, wall, mean of "
        f"{GRAPH_K}): graphed {out['graph_1']:.2f}, eager "
        f"{out['eager_1']:.2f}; the group before, graphed (its first step "
        f"warms up, its second captures) {out['graph_0']:.2f}, eager "
        f"{out['eager_0']:.2f}; capture {c.seconds:.3f} s, pool "
        f"+{c.pool_bytes / 2**30:.2f} GiB; peak memory graphed "
        f"{g_peak / 2**30:.2f} GiB, eager {e_peak / 2**30:.2f} GiB")
    return launches


def _eager_request(model, vocoder, buckets, frame_buckets, sigma, call):
    """load_tts's request path without graphs: pad to the bucket, stage A,
    the frame bucket from the real rows, stage B drawing the latent from
    a generator of the request's seed, the vocoder, int16 PCM."""
    from radmmm_torch.serving import _pad_request, _quantize_pcm
    text, *per_item, seed = call
    _, b, text_p, padded = _pad_request(buckets, text, per_item)
    dev = torch.device("cuda")
    t = [torch.as_tensor(a, device=dev) for a in (text_p, *padded)]
    with torch.inference_mode():
        d = model.infer_durations(t[0], t[1], t[2], accent_ids=t[3])
        need = int(d["n_frames"][:b].max())
        F = next((f for f in frame_buckets if f >= need), frame_buckets[-1])
        out = model.infer_decode(
            d["txt_enc"], d["durations"], t[2], accent_ids=t[3],
            f0_mean=t[4], f0_std=t[5], sigma=sigma, max_frames=F,
            generator=torch.Generator(device=dev).manual_seed(int(seed)))
        audio = _quantize_pcm(vocoder(out["mel"]))
    return audio[:b], out["lens"].lengths[:b]


def _graph_calls(seed: int, B: int, n: int) -> list:
    """n requests of B texts of 40 to 96 tokens, seeds 100 on."""
    rng = np.random.default_rng(seed + B)
    calls = []
    for k in range(n):
        lens = rng.integers(40, 97, B)
        text = np.zeros((B, int(lens.max())), np.int32)
        for i, L in enumerate(lens):
            text[i, :L] = rng.integers(1, 426, L)
        calls.append((text, lens.astype(np.int32),
                      rng.integers(0, 21, B).astype(np.int32),
                      rng.integers(0, 7, B).astype(np.int32),
                      rng.uniform(4.8, 5.4, B).astype(np.float32),
                      rng.uniform(0.25, 0.4, B).astype(np.float32),
                      100 + k))
    return calls


def _graphs_serve(seed: int, work: str) -> dict:
    """Part (b): the serving artifact at GRAPH_TEXT_BUCKETS and the frame
    buckets loaded with load_tts on the card (every bucket captured at
    load), GRAPH_REQUESTS requests at each text bucket against the eager
    request path, in turns, the same seeds: int16 PCM equal, p50 and p99
    ms each way (after one untimed request each way at the bucket); then
    one request a bucket in bf16 against bf16 eager. Returns the graphed
    requests' launches."""
    from radmmm_torch.serving import export_tts, load_tts
    model, vocoder = build_models(seed)
    path = f"{work}/graphs_tts.pt"
    export_tts(model, path, vocoder=vocoder, buckets=GRAPH_TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    model = model.cuda().eval().cache_inverses()
    vocoder = vocoder.cuda().eval()
    results = {}
    for mode in ("f32", "bf16"):
        with conv_precision(mode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            served = load_tts(path, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            caps = served.graphs.captures
            log(f"[graphs] ({mode}) load_tts with {len(caps)} captures in "
                f"{load_s:.2f} s: " + "; ".join(
                    f"{c.name} B={c.signature[3][0][0]} {c.seconds:.3f} s "
                    f"+{c.pool_bytes / 2**20:.1f} MiB" for c in caps))
            if len(caps) != len(GRAPH_TEXT_BUCKETS) * (1 + len(FRAME_BUCKETS)):
                fail(f"({mode}) load_tts did not capture every bucket")
            n = GRAPH_REQUESTS if mode == "f32" else 1
            graphed_launches = {k: 0 for k in _counters()}
            for B, _ in GRAPH_TEXT_BUCKETS:
                # one untimed request each way at the bucket first (the
                # eager path's first call at a shape sets up its libraries)
                (warm,) = _graph_calls(seed + 1, B, 1)
                served(*warm)
                _eager_request(model, vocoder, served.buckets, FRAME_BUCKETS,
                               0.8, warm)
                times = {"graphed": [], "eager": []}
                for k, call in enumerate(_graph_calls(seed, B, n)):
                    for way in (("graphed", "eager") if k % 2 == 0
                                else ("eager", "graphed")):
                        t0 = time.perf_counter()
                        if way == "graphed":
                            before = _counters()
                            g, gl = served(*call)
                            graphed_launches = {
                                k: v + _counters()[k] - before[k]
                                for k, v in graphed_launches.items()}
                        else:
                            e, el = _eager_request(
                                model, vocoder, served.buckets,
                                FRAME_BUCKETS, 0.8, call)
                        torch.cuda.synchronize()
                        times[way].append((time.perf_counter() - t0) * 1e3)
                    if not (torch.equal(g, e) and torch.equal(gl, el)):
                        fail(f"({mode}) bucket B={B} seed {call[-1]}: graphed "
                             f"PCM differs from eager by "
                             f"{(g.int() - e.int()).abs().max().item()} "
                             "LSB")
                results[(mode, B)] = times
                log(f"[graphs] ({mode}) bucket ({B}, 96), {n} requests, "
                    f"graphed PCM equal to eager: " + ", ".join(
                        f"{w} p50 {np.percentile(v, 50):.2f} ms p99 "
                        f"{np.percentile(v, 99):.2f} ms"
                        for w, v in times.items()))
            if mode == "f32":
                launches = graphed_launches
                log(f"[graphs] graphed requests' launches {launches}")
                if launches["lstm_recurrence"] != 4 * n * len(
                        GRAPH_TEXT_BUCKETS):
                    fail("the graphed requests did not launch K4 4 times "
                         "each (the launch ledger)")
            del served
            torch.cuda.empty_cache()
    return launches


GRAPH_FIT_K = 4
GRAPH_FIT_STEPS = 24
GRAPH_FIT_LINES = 64    # copies of each source's line: 8 batches a shape
# part (f): the fit phase's corpus at 32 lines a source, each of its own
# length (8 batches an epoch; over 24 steps 6 shapes and groups of 1, 4,
# 2, 1, 3, 3, 1, 1, 1, 3, 1 and 3, as the loader deals them from its
# seed), the binarization switch inside the group of steps 1-4 and the KL
# switch (on from step 13) inside that of steps 11-13; 11 signatures of
# (shape, phase, RAdam branch), so 13 steps replay; validation every 8
# steps (one batch: warmed up at 8, captured at 16, replayed at 24)
GRAPH_MIXED_LINES = 32
GRAPH_MIXED_BINARIZE, GRAPH_MIXED_KL, GRAPH_MIXED_VAL = 3, 12, 8
# (f) at megastep_k GRAPH_FIT_K logs the validation samples: the recipe's
# prompts of the corpus's two speakers (their own languages), vocoded by a
# HiFi-GAN v1 g_* file of random weights with its Denoiser; each
# validation launches the losses' and samples' K4 10, K1 1 and K3 3 (its
# binarized eval forward and reconstruct), and the prompts' infer K4 4;
# K7 forwards run in four passes of the flow (``_val_launches``)
GRAPH_SAMPLE_SPEAKERS = ("ljs-other", "mailabs-tux-other")
VAL_LAUNCHES = dict.fromkeys(FIT_STEP, 0)
VAL_LAUNCHES.update(lstm_recurrence=10 + 4, ctc_alpha=1, mas_width1=3)
# the flow's passes in one validation with samples: the losses' forward,
# the eval forward, reconstruct's inverse and the prompts' infer
VAL_FLOW_PASSES = 4
# the trainer's inference programs (utils/graphs names)
SAMPLE_PROGRAMS = ("tts_infer", "val_forward", "reconstruct", "vocode")
# RAdam's rectified branch from the sixth update (N_sma >= 5 at b2 0.999)
RADAM_RECTIFIED_FROM = 5
# part (g): fit --distributed on two cards over NCCL, the ddp phase's
# corpus (one shape: whole rounds) in groups of 4, validated every 6 steps;
# ms a step over the whole group of steps 8-11 (every one replays), step
# 13 traced (the profiler's start and stop, seconds each, fall in the
# walls of steps 12 and 13, start to start)
GRAPH_NCCL_STEPS, GRAPH_NCCL_VAL, GRAPH_NCCL_PROFILED = 16, 6, 13
GRAPH_NCCL_TIMED = range(8, 12)
GRAPH_NCCL_TIMEOUT = 300    # a run's seconds: a rank left alone in a
                            # capture would wait on its peer for ever


class _EagerSteps:
    """The trainer's eager baseline: inside, ``cli.main`` builds a
    ``Trainer`` whose step factory hands the training and validation
    steps no graph pool and whose loaders' featurizer gets none, so every
    step and every featurize call runs eagerly (the graphs' own code path
    otherwise: the same loop, bookkeeping and batches)."""

    def __enter__(self):
        from radmmm_torch.training import cli
        from radmmm_torch.training.loop import Trainer

        class EagerTrainer(Trainer):
            def _step_pool(self):
                return None

            def _featurizer_pool(self):
                return None

        self.cli, self.orig = cli, cli.Trainer
        cli.Trainer = EagerTrainer
        return self

    def __exit__(self, *exc):
        self.cli.Trainer = self.orig


@contextlib.contextmanager
def _per_step(records: list, profiled: int = -1):
    """Record every training step of a fit into ``records``: its step,
    the kernels' launches (``_counters(loaders=True)``), whether it replayed a graph and whether it
    captured one first (its signature's second sighting), its batch's shape
    (the audio's, the raw batch's where the step featurizes, and the
    text's) and, for step ``profiled``, ``traced``'s profile of it."""
    from radmmm_torch.training.loop import Trainer
    orig = Trainer._run_step

    def run_step(self, state, batch, step, gen, featurizer=None):
        pool = self._graph_pool
        before, replays, captures = (_counters(loaders=True), pool.replays,
                                     len(pool.captures))
        audio = batch.get("audio_i16", batch.get("audio"))
        rec = dict(step=step, shape=(tuple(audio.shape),
                                     tuple(batch["text"].shape)))
        if step == profiled:
            out, rec["profile"] = traced(
                lambda: orig(self, state, batch, step, gen, featurizer))
        else:
            out = orig(self, state, batch, step, gen, featurizer)
        after = _counters(loaders=True)
        rec.update(launches={k: after[k] - before[k] for k in after},
                   graphed=pool.replays > replays,
                   captured=len(pool.captures) > captures)
        records.append(rec)
        return out

    Trainer._run_step = run_step
    try:
        yield
    finally:
        Trainer._run_step = orig


@contextlib.contextmanager
def _group_sizes(sizes: list):
    """Record the size of every group of raw batches the trainer takes."""
    from radmmm_torch.training import loop
    orig = loop.prefetch_raw_groups

    def groups(*a, **kw):
        for g in orig(*a, **kw):
            sizes.append(int(next(iter(g.values())).shape[0]))
            yield g

    loop.prefetch_raw_groups = groups
    try:
        yield
    finally:
        loop.prefetch_raw_groups = orig


@contextlib.contextmanager
def _graph_replays(counts: collections.Counter):
    """Count every graph's replays by its name into ``counts``."""
    from radmmm_torch.utils import graphs
    orig = graphs.StepGraph.__call__

    def call(self, inputs):
        before = self.pool.replays
        out = orig(self, inputs)
        counts[self.name] += self.pool.replays - before
        return out

    graphs.StepGraph.__call__ = call
    try:
        yield
    finally:
        graphs.StepGraph.__call__ = orig


def _on_host(tree):
    from torch.utils import _pytree as pytree
    return pytree.tree_map(lambda t: t.detach().cpu()
                           if isinstance(t, torch.Tensor) else t, tree)


@contextlib.contextmanager
def _samples(records: list):
    """Record the result of every call of the trainer's sample programs
    and its vocoding (``Trainer._infer``, ``_val_forward``,
    ``_reconstruct``, ``_vocode``), on the host, as (name, result)."""
    from radmmm_torch.training.loop import Trainer
    names = ("_infer", "_val_forward", "_reconstruct", "_vocode")
    origs = {n: getattr(Trainer, n) for n in names}

    def recorded(name, orig):
        def call(self, *a, **kw):
            out = orig(self, *a, **kw)
            records.append((name, _on_host(out)))
            return out
        return call

    for n, orig in origs.items():
        setattr(Trainer, n, recorded(n, orig))
    try:
        yield
    finally:
        for n, orig in origs.items():
            setattr(Trainer, n, orig)


def _records_equal(got: list, want: list) -> bool:
    from torch.utils import _pytree as pytree
    if [n for n, _ in got] != [n for n, _ in want]:
        return False
    return all(torch.equal(a, b) for (_, g), (_, w) in zip(got, want)
               for a, b in zip(pytree.tree_leaves(g), pytree.tree_leaves(w)))


def _step_walls(stats, steps) -> list:
    """Each of ``steps``' wall ms (0-based, relative to the fit's first
    step): start to next start, less the validation and checkpoint after
    it."""
    starts, pauses = stats["step_starts"], stats["pause_s"]
    return [1e3 * (starts[i + 1] - starts[i] - pauses.get(i + 1, 0.0))
            for i in steps]


def _graphs_fit(seed: int, work: str) -> dict:
    """Part (e): the recipe at full width through the training CLI for
    GRAPH_FIT_STEPS steps with megastep_k GRAPH_FIT_K, graphed and with
    the trainer's eager steps (``_EagerSteps``), on a corpus of
    GRAPH_FIT_LINES copies of a line a source, so that groups of one shape
    form; no validation, one checkpoint at the end. The logged losses of
    the two runs (whole groups log once, after their last step), each
    step's launches, the warm-ups, captures and replays, and ms a step
    over steps 12-19 (two whole groups, start to start, their bookkeeping
    in) each way. Returns the graphed fit's launches."""
    import os
    overlay = fit_overlay(work, ddp_corpus(work, seed, GRAPH_FIT_LINES))
    base = [a for c in RECIPE + (overlay,) for a in ("-c", c)] + [
        f"--trainer.max_steps={GRAPH_FIT_STEPS}",
        f"--trainer.megastep_k={GRAPH_FIT_K}",
        "--trainer.val_check_interval=100000",
        "--model.iters_per_checkpoint=100000"]
    runs = {}
    for way in ("graphed", "eager"):
        run_dir = os.path.join(work, f"run_e_{way}")
        _zero_counters()
        with _EagerSteps() if way == "eager" else contextlib.nullcontext():
            _, tr, _, fit_s = _run_cli(
                ["fit"] + base + [f"--model.output_directory={run_dir}"],
                f"fit to {GRAPH_FIT_STEPS} steps, megastep_k {GRAPH_FIT_K}, "
                f"{way}", "graphs")
        # ms a step over the whole groups of steps 12-19, start to start
        # (the host queues a group's replays, then waits at its end)
        lo, hi = 12, 12 + 2 * GRAPH_FIT_K
        wall = float(np.mean(_step_walls(tr.stats, range(lo, hi))))
        st = tr.stats
        runs[way] = dict(launches=_counters(loaders=True), rows=[
            r for r in _metrics_rows(run_dir) if "train/loss" in r],
            wall=wall, fit_s=fit_s, **{k: st[k] for k in (
                "warmups", "captures", "replays", "graphed_steps",
                "megastep_steps")})
        log(f"[graphs] (e) fit {way}: {fit_s:.2f} s, ms a step over steps "
            f"{lo}-{hi - 1}: {wall:.2f}; {st['graphed_steps']} of "
            f"{st['steps']} steps replayed a graph, {st['megastep_steps']} "
            f"in whole groups; warm-ups {st['warmups']}, captures "
            f"{st['captures']}, replays {st['replays']}; launches "
            f"{runs[way]['launches']}")
    g, e = runs["graphed"], runs["eager"]
    want = {name: n * GRAPH_FIT_STEPS for name, n in FIT_STEP.items()}
    want["mas_width1"] = GRAPH_FIT_STEPS - FIT_BINARIZE_FROM
    if g["launches"] != want or e["launches"] != want:
        fail(f"(e) the fits' launches {g['launches']} (graphed), "
             f"{e['launches']} (eager), expected {want}")
    # every step but each (phase, RAdam branch)'s first replays: the
    # phases plain, binarized and binarized with KL, RAdam's plain branch
    # in the first two, its rectified one from step 6
    if g["graphed_steps"] != GRAPH_FIT_STEPS - g["warmups"] or \
            e["graphed_steps"] or e["captures"]:
        fail(f"(e) graphed steps {g['graphed_steps']} of {GRAPH_FIT_STEPS} "
             f"with {g['warmups']} warm-ups; eager {e['graphed_steps']}")
    for way, run in runs.items():
        steps = [r["step"] for r in run["rows"]]
        bad = [r for r in run["rows"] if not math.isfinite(r["train/loss"])]
        log(f"[graphs] (e) fit {way}: logged steps {steps}, train/loss "
            + ", ".join(f"{r['train/loss']:.6f}" for r in run["rows"]))
        if bad or steps[-1] != GRAPH_FIT_STEPS:
            fail(f"(e) the {way} fit logged {bad or steps}")
    log(f"[graphs] (e) fit: ms a step {g['wall']:.2f} graphed, "
        f"{e['wall']:.2f} eager (megastep_k {GRAPH_FIT_K}, cuDNN's default "
        f"algorithms; the runs' losses differ, since four loader threads "
        f"draw the augmentations in their own order: (f) holds them equal)")
    return g["launches"]


def _graphs_mixed(seed: int, work: str, k: int, samples: bool = False
                  ) -> dict:
    """Part (f): the recipe at full width through the training CLI for
    GRAPH_FIT_STEPS steps with megastep_k ``k`` on the fit phase's corpus
    (lines of their own lengths: with ``k`` GRAPH_FIT_K most groups
    partial; with ``k`` 1 the loop that takes the loader's featurized
    batches at their natural bucket shapes and graphs the step alone), the
    binarization and KL switches inside groups, validation on (the
    losses; no samples) and one loader thread, graphed and with the
    trainer's eager steps, both under cuDNN's deterministic algorithms:
    the logged losses bit for bit, every step's launches and the
    validations' alike, the groups (whole, partial, straddling), steps,
    graphed steps (those of the signatures seen before, so the steps less
    the train step's warm-ups), warm-ups, captures and replays, ms a step
    over the steps that replayed against the same steps eager, and
    validation seconds each way. With ``samples``, each validation also
    logs its samples (the prompts' TTS audio, the attention maps, the
    reconstruction, its audio and the quality scalars), vocoded by a
    HiFi-GAN with its Denoiser: every sample bit for bit, the sample
    programs replaying from the second validation on (the third after
    training steps, with their weights), and then ``predict`` in
    reconstruction mode over the training set's batches, graphed against
    eager (``_samples``' records bit for bit, ms a batch). Returns the
    graphed fit's launches."""
    import os
    from radmmm_torch.training.loop import Trainer
    from radmmm_torch.training.step import LossConfig, phase_flags
    part = "(f)" if k > 1 else "(f, megastep_k 1)"
    root = os.path.join(work, f"mixed_k{k}")
    os.makedirs(root)
    overlay = fit_overlay(root, fit_corpus(root, seed, GRAPH_MIXED_LINES))
    base = [a for c in RECIPE + (overlay,) for a in ("-c", c)] + [
        f"--trainer.max_steps={GRAPH_FIT_STEPS}",
        f"--trainer.megastep_k={k}",
        f"--trainer.val_check_interval={GRAPH_MIXED_VAL}",
        f"--model.binarization_start_iter={GRAPH_MIXED_BINARIZE}",
        "--model.decoder_loss.init_args.kl_loss_start_iter="
        f"{GRAPH_MIXED_KL}",
        "--model.iters_per_checkpoint=100000", "--data.num_workers=1"]
    if samples:
        g_path, g_cfg = write_g_file(root, seed)
        with open("model_inputs/resynthesis_prompts.json") as f:
            prompts = [p for p in json.load(f)
                       if p["spk_id"] in GRAPH_SAMPLE_SPEAKERS]
        ppath = _write_overlay(root, "prompts.json", prompts)
        base += ["--trainer.log_decoder_samples=True",
                 f"--trainer.val_prompts_path={ppath}",
                 f"--model.vocoder_checkpoint_path={g_path}",
                 f"--model.vocoder_config_path={g_cfg}"]
    else:
        base.append("--trainer.log_decoder_samples=False")
    cfg = LossConfig(binarization_start_iter=GRAPH_MIXED_BINARIZE,
                     kl_loss_start_iter=GRAPH_MIXED_KL)
    runs = {}
    for way in ("graphed", "eager"):
        run_dir = os.path.join(root, f"run_{way}")
        steps, vals, val_s, sizes, recs = [], [], [], [], []
        replays = collections.Counter()
        _zero_counters()
        with cudnn_deterministic(), _per_step(steps), _group_sizes(sizes), \
                _counted(Trainer, "validate", vals, val_s), \
                _samples(recs), _graph_replays(replays), \
                _EagerSteps() if way == "eager" else contextlib.nullcontext():
            _, tr, _, fit_s = _run_cli(
                ["fit"] + base + [f"--model.output_directory={run_dir}"],
                f"{part} fit to {GRAPH_FIT_STEPS} steps, {way}", "graphs")
        pool_mib = {n: sum(c.pool_bytes for c in tr._graph_pool.captures
                           if c.name == n) / 2**20
                    for n in ("train_step", "val_step") + SAMPLE_PROGRAMS}
        st = tr.stats
        kinds, at = collections.Counter(), 0
        for n in sizes:
            kinds["partial" if n < k else "straddling"
                  if phase_flags(at, cfg) != phase_flags(at + n - 1, cfg)
                  else "whole"] += 1
            at += n
        runs[way] = dict(
            steps=steps, vals=vals, val_s=val_s,
            val_launches=_val_launches(tr.model),
            launches=_counters(loaders=True),
            stats=st, recs=recs, replays=replays, pool_mib=pool_mib,
            kinds=kinds, sizes=sizes,
            rows=[r for r in _metrics_rows(run_dir) if "train/loss" in r],
            val_rows=[r for r in _metrics_rows(run_dir)
                      if "val/loss" in r])
        log(f"[graphs] {part} {way}: {fit_s:.2f} s; groups {sizes} "
            f"({dict(kinds)}); {st['steps']} steps, {st['graphed_steps']} "
            f"replayed a graph, {st['megastep_steps']} in whole groups; "
            f"warm-ups {st['warmups']}, captures {st['captures']}, replays "
            f"{st['replays']} (steps and validation batches); batch shapes "
            f"{sorted(collections.Counter(r['shape'] for r in steps).items())}"
            f"; validation {st['val_s']:.3f} s in {len(vals)}")
        log(f"[graphs] {part} {way}: the loaders' featurize calls (the "
            f"first batch, {'every step, ' if k == 1 else ''}validation): "
            f"warm-ups {st['featurize_warmups']}, captures "
            f"{st['featurize_captures']}, replays {st['featurize_replays']},"
            f" pool {st['featurize_pool_bytes'] / 2**20:.1f} MiB; waiting "
            f"on the loader {st['loader_wait_s']:.3f} s, "
            f"{100 * st['loader_wait_s'] / max(st['train_s'], 1e-9):.1f}% "
            f"of the training seconds")
        if samples:
            log(f"[graphs] {part} {way}: replays by graph {dict(replays)}; "
                f"the pool's growth at each graph's captures, MiB: "
                + ", ".join(f"{n} {v:.1f}" for n, v in pool_mib.items())
                + f" (all {st['graph_pool_bytes'] / 2**20:.1f}); "
                f"{len(recs)} sample results recorded")
            runs[way]["predict"] = _graphs_predict_reconstruction(
                base, run_dir, part, way)
    g, e = runs["graphed"], runs["eager"]
    if k > 1 and (len({r["shape"] for r in g["steps"]}) < 3 or not g[
            "kinds"]["partial"] or not g["kinds"]["straddling"]):
        fail("(f) expected 3 batch shapes or more and partial and "
             "straddling groups")
    # megastep_k 1: the loop of featurized batches, no group taken and no
    # step featurizing (a step's noise key is None where the loader
    # featurizes)
    if k == 1 and (g["sizes"] or any(key is not None for key in
                                     g["stats"]["noise_keys"])):
        fail(f"{part} the fit took raw groups {g['sizes']}, not the "
             f"loader's featurized batches")
    # at megastep_k 1 the loader featurizes every step: its signatures'
    # later calls replay; the eager run's featurizer has no graphs
    if (k == 1 and not g["stats"]["featurize_replays"]) or any(
            e["stats"][f"featurize_{n}"]
            for n in ("warmups", "captures", "replays")):
        fail(f"{part} the loaders' featurize replays: graphed "
             f"{g['stats']['featurize_replays']}, eager "
             f"{e['stats']['featurize_replays']}")
    if [r["launches"] for r in g["steps"]] != [
            r["launches"] for r in e["steps"]] or g["vals"] != e["vals"] \
            or g["launches"] != e["launches"]:
        fail(f"{part} launches graphed {g['launches']}, eager "
             f"{e['launches']}")
    # every step replays but each signature's first sighting: a (shape,
    # phase, RAdam branch) seen once is only warmed up
    seen, want = set(), []
    for r in g["steps"]:
        sig = (r["shape"], phase_flags(r["step"], cfg),
               r["step"] >= RADAM_RECTIFIED_FROM)
        want.append(sig in seen)
        seen.add(sig)
    n_val = len(e["val_rows"])
    log(f"[graphs] {part} {len(seen)} signatures of (shape, phase, RAdam "
        f"branch) over {GRAPH_FIT_STEPS} steps; graphed by step "
        + "".join("R" if r["graphed"] else "." for r in g["steps"]))
    if [r["graphed"] for r in g["steps"]] != want or \
            g["stats"]["graphed_steps"] != GRAPH_FIT_STEPS - len(seen) or \
            not any(want) or \
            e["stats"]["graphed_steps"] or e["stats"]["captures"]:
        fail(f"{part} the steps that replayed a graph are not those whose "
             f"signature was seen before ({sum(want)} of "
             f"{GRAPH_FIT_STEPS}, {len(seen)} warm-ups of the step; "
             f"graphed {g['stats']['graphed_steps']}); eager "
             f"{e['stats']['graphed_steps']}")
    def losses(rows):
        return [{k: v for k, v in r.items() if k != "train/steps_per_sec"}
                for r in rows]

    equal = (losses(g["rows"]) == losses(e["rows"])
             and g["val_rows"] == e["val_rows"])
    log(f"[graphs] {part} deterministic cuDNN: {len(g['rows'])} logged "
        f"steps' "
        f"loss terms and {n_val} validations' losses, graphed "
        f"against eager, bit-equal {equal}; train/loss by step, graphed: "
        + ", ".join(f"{r['step']}: {r['train/loss']!r}" for r in g["rows"]))
    if not equal:
        fail(f"{part} the graphed fit's losses are not the eager fit's")
    # the steady steps: those that replayed without capturing first
    steady = [r["step"] for r in g["steps"] if r["graphed"]
              and not r["captured"] and r["step"] < GRAPH_FIT_STEPS - 1]
    captured = [r["step"] for r in g["steps"] if r["captured"]]
    for what, steps in (("replayed a graph captured earlier", steady),
                        ("captured, then replayed", captured)):
        gw = _step_walls(g["stats"], steps)
        ew = _step_walls(e["stats"], steps)
        log(f"[graphs] {part} ms a step over the {len(steps)} steps that "
            f"{what} (start to next start, validation out): graphed "
            f"{np.mean(gw):.2f} (median {np.median(gw):.2f}), the same "
            f"steps eager {np.mean(ew):.2f} (median {np.median(ew):.2f})")
    what = ("the losses of one batch and the samples" if samples
            else "the losses of one batch")
    log(f"[graphs] {part} validation seconds, each of {len(g['val_s'])} "
        f"({what}; graphed: a warm-up, a capture and a "
        f"replay): graphed " + ", ".join(f"{x:.3f}" for x in g["val_s"])
        + ", eager " + ", ".join(f"{x:.3f}" for x in e["val_s"]))
    if samples:
        _check_samples(part, g, e)
    return g["launches"]


def _val_launches(model) -> dict:
    """A validation's launches with samples: VAL_LAUNCHES, and K7's
    forwards of ``model``'s WN stacks in each of the flow's passes."""
    k7 = _wn_launches(model, False).get("wn_conv_fwd", 0)
    return dict(VAL_LAUNCHES, wn_conv_fwd=VAL_FLOW_PASSES * k7)


def _check_samples(part: str, g: dict, e: dict) -> None:
    """(f)'s samples and predict_reconstruction, graphed against eager."""
    want = g["val_launches"]
    if any(v != want for v in g["vals"] + e["vals"]) or \
            len(g["vals"]) < 3:
        fail(f"{part} a validation's launches: graphed {g['vals']}, eager "
             f"{e['vals']}, expected {len(g['vals'])} (3 or more) of "
             f"{want}")
    equal = _records_equal(g["recs"], e["recs"])
    log(f"[graphs] {part} the validations' samples ("
        + ", ".join(f"{n} {c}" for n, c in collections.Counter(
            n for n, _ in g["recs"]).items())
        + " calls: mels, attention maps, predictor outputs, audio) graphed "
        f"against eager, bit-equal {equal}; the quality scalars are in the "
        f"validation rows compared above; each validation launched "
        f"{want}")
    if not equal:
        fail(f"{part} the graphed validation samples are not the eager ones")
    missing = [n for n in SAMPLE_PROGRAMS if not g["replays"][n]]
    if missing or any(e["replays"].values()):
        fail(f"{part} sample programs that never replayed: {missing}; "
             f"eager replays {dict(e['replays'])}")
    gp, ep = g["predict"], e["predict"]
    equal = _records_equal(gp["recs"], ep["recs"])
    replaying = [i for i, r in enumerate(gp["replayed"]) if r]
    log(f"[graphs] {part} predict_reconstruction over {gp['batches']} "
        f"batches of mel shapes {gp['shapes']}: graphed against eager, "
        f"bit-equal {equal}; graphed replays {dict(gp['replays'])}, by "
        f"batch " + "".join("R" if r else "." for r in gp["replayed"])
        + "; ms a batch (reconstruct + vocode, each synchronised), graphed "
        + ", ".join(f"{x:.2f}" for x in gp["ms"]) + ", eager " + ", ".join(
            f"{x:.2f}" for x in ep["ms"]) + f"; the {len(replaying)} batches "
        f"whose reconstruct replayed: graphed mean "
        f"{np.mean([gp['ms'][i] for i in replaying]):.2f}, the same batches "
        f"eager {np.mean([ep['ms'][i] for i in replaying]):.2f}")
    if not equal or gp["batches"] < 4 or not gp["replays"]["reconstruct"] \
            or not gp["replays"]["vocode"] or any(ep["replays"].values()):
        fail(f"{part} predict_reconstruction: bit-equal {equal}, "
             f"{gp['batches']} batches, replays {dict(gp['replays'])}, "
             f"eager {dict(ep['replays'])}")


def _graphs_predict_reconstruction(base: list, run_dir: str, part: str,
                                   way: str) -> dict:
    """``predict`` in reconstruction mode from ``run_dir``'s checkpoint
    over the training set, in the way of the fit before it (graphed, or
    the trainer's eager programs): its samples' records, replays by graph,
    batches and their shapes, and ms a batch (reconstruct and vocode, each
    synchronised at its end)."""
    from radmmm_torch.training.loop import Trainer
    recs, rec_s, voc_s, shapes, replayed = [], [], [], [], []
    replays = collections.Counter()
    orig = Trainer._reconstruct

    def reconstruct(self, batch, generator):
        shapes.append(tuple(batch["mel"].shape))
        before = self._graph_pool.replays
        out = orig(self, batch, generator)
        replayed.append(self._graph_pool.replays > before)
        return out

    Trainer._reconstruct = reconstruct
    try:
        with cudnn_deterministic(), _samples(recs), _graph_replays(replays), \
                _counted(Trainer, "_reconstruct", [], rec_s), \
                _counted(Trainer, "_vocode", [], voc_s), \
                _EagerSteps() if way == "eager" else contextlib.nullcontext():
            _run_cli(["predict"] + base + [
                f"--model.output_directory={run_dir}",
                "--model.predict_mode=reconstruction"],
                f"{part} predict_reconstruction, {way}", "graphs")
    finally:
        Trainer._reconstruct = orig
    return dict(recs=recs, replays=replays, batches=len(shapes),
                shapes=sorted(collections.Counter(shapes).items()),
                replayed=replayed,
                ms=[1e3 * (a + b) for a, b in zip(rec_s, voc_s)])


def _graphs_nccl(seed: int, work: str) -> dict:
    """Part (g), with two cards or more: ``fit --distributed`` over NCCL
    with n_data 2 as the ddp phase's part (c) runs it (torchrun, a card a
    rank, its corpus of whole rounds), GRAPH_NCCL_STEPS steps in groups of
    GRAPH_FIT_K, validated every GRAPH_NCCL_VAL steps (losses only), once
    graphed and once with the trainer's eager steps: rank 0's loss terms
    within the ddp phase's bounds (1e-5 + TRAIN_PARITY_RTOL relative;
    the wave augmentations off, so both runs load the same batches from
    the loader's four threads, which would draw augmentations in their
    own order), its collectives (counts and bytes) and launches alike, ms a
    step over the whole group GRAPH_NCCL_TIMED (start to next start: the
    host queues a group's replays, then waits at its end) each way, each
    step's wall, and step GRAPH_NCCL_PROFILED
    profiled (wall, busy, host launch calls) each way. Returns rank 0's
    graphed launches."""
    import os
    root = os.path.join(work, "nccl")
    os.makedirs(root)
    overlay = fit_overlay(root, ddp_corpus(root, seed))
    argv = ["fit"] + [a for c in RECIPE + (overlay,) for a in ("-c", c)] + [
        "--distributed", f"--trainer.max_steps={GRAPH_NCCL_STEPS}",
        f"--trainer.megastep_k={GRAPH_FIT_K}",
        f"--trainer.val_check_interval={GRAPH_NCCL_VAL}",
        "--model.iters_per_checkpoint=100000",
        "--trainer.log_decoder_samples=False",
        "--data.use_wave_augmentations=False"]
    runs = {}
    for way in ("graphed", "eager"):
        res_dir = os.path.join(root, f"ranks_{way}")
        os.makedirs(res_dir)
        run = argv + [f"--model.output_directory={root}/run_{way}"]
        opts = [f"profile:{GRAPH_NCCL_PROFILED}"] + (
            ["eager"] if way == "eager" else [])
        t0 = time.perf_counter()
        _run_children([[
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2", __file__, "--ddp-fit-child", res_dir,
            *opts, "--"] + run], GRAPH_NCCL_TIMEOUT, f"graphs (g) {way}")
        res = [json.load(open(os.path.join(res_dir, f"rank{r}.json")))
               for r in range(2)]
        runs[way] = dict(res=res, rows=[
            r for r in _metrics_rows(f"{root}/run_{way}")
            if "train/loss" in r])
        r0 = res[0]
        p = r0["profile"]
        log(f"[graphs_nccl] (g) {way}, 2 ranks over NCCL in "
            f"{time.perf_counter() - t0:.1f} s: rank 0 {r0['n_steps']} steps"
            f", {sum(r0['graphed'])} replayed a graph captured earlier "
            f"(warm-ups "
            f"{r0['warmups']}, captures {r0['captures']}, replays "
            f"{r0['replays']}); {100 * r0['loader_share']:.1f}% of the fit "
            f"waiting on the loader; collectives {r0['collectives']}; "
            f"launches "
            f"{r0['launches']}; step {GRAPH_NCCL_PROFILED} traced: wall "
            f"{p['wall_ms']:.2f} ms, busy {p['busy_ms']:.2f} ms, "
            f"{p['host_launches']} host launch calls {p['host_calls']}; "
            f"each step's ms, start to next start, validation out: "
            + ", ".join(f"{w:.1f}" for w in r0["walls"]))
        if res[0]["sums"] != res[1]["sums"]:
            fail(f"(g) {way}: the ranks' parameters differ")
    g, e = runs["graphed"], runs["eager"]
    g0, e0 = g["res"][0], e["res"][0]
    if g0["collectives"] != e0["collectives"] or \
            g0["launches"] != e0["launches"]:
        fail("(g) the graphed fit's collectives or launches are not the "
             "eager fit's")
    if not all(g0["graphed"][i] for i in GRAPH_NCCL_TIMED) or \
            e0["captures"]:
        fail(f"(g) steps {list(GRAPH_NCCL_TIMED)} did not all replay a "
             f"graph captured earlier, or the eager fit captured")
    worst = 0.0
    for a, b in zip(g["rows"], e["rows"]):
        for k, want in b.items():
            if k in ("step", "train/steps_per_sec"):
                continue
            err = abs(a[k] - want)
            worst = max(worst, err / (1e-5 + abs(want)))
            if not (math.isfinite(a[k]) and err <= 1e-5
                    + TRAIN_PARITY_RTOL * abs(want)):
                fail(f"(g) step {b['step']} {k}: graphed {a[k]!r}, eager "
                     f"{want!r}")
    gw = [g0["walls"][i] for i in GRAPH_NCCL_TIMED]
    ew = [e0["walls"][i] for i in GRAPH_NCCL_TIMED]
    log(f"[graphs_nccl] (g) loss terms of {len(g['rows'])} logged steps, "
        f"graphed against eager: worst relative {worst:.3e} (rtol "
        f"{TRAIN_PARITY_RTOL:g}); ms a step over the whole group of steps "
        f"{GRAPH_NCCL_TIMED[0]}-{GRAPH_NCCL_TIMED[-1]}, every one replaying "
        f"a graph captured earlier: graphed "
        f"{np.mean(gw):.2f}, eager {np.mean(ew):.2f};"
        f" a traced step's host launch calls: graphed "
        f"{g0['profile']['host_launches']}, eager "
        f"{e0['profile']['host_launches']}; wall against busy: graphed "
        f"{g0['profile']['wall_ms']:.2f} / {g0['profile']['busy_ms']:.2f} "
        f"ms, eager {e0['profile']['wall_ms']:.2f} / "
        f"{e0['profile']['busy_ms']:.2f} ms")
    return g0["launches"]


def _graphs_aug(work: str) -> None:
    """Part (c): the port's aug_disentangle_experiment script at 16 steps
    a fit (8 training and 2 held-out utterances a pair) on the card: both
    fits, both evaluations, metrics.json in the JAX run's schema."""
    import os
    from radmmm_torch.scripts import aug_disentangle_experiment as aug
    t0 = time.perf_counter()
    meta = aug.main(["--steps", "16", "--n-train", "8", "--n-val", "2",
                     "--workdir", os.path.join(work, "aug"),
                     "--outdir", os.path.join(work, "aug", "out")])
    res = meta["results"]
    log(f"[graphs] aug_disentangle_experiment at 16 steps in "
        f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
            f"{arm} " + ", ".join(f"{k} {v}" for k, v in r.items())
            for arm, r in res.items()))
    bad = [(arm, k) for arm, r in res.items() for k in
           ("cross_nll", "cross_recon_mel_l1", "emb_cross_cov")
           if not math.isfinite(r[k])]
    if bad or any(r["ckpt_step"] != 16 for r in res.values()):
        fail(f"the aug experiment's script gave {res}")


@tf32_off()
def phase_graphs(seed: int) -> dict:
    """The graphs phase: (a) graphed against eager training in f32 and
    bf16, (b) graphed against eager serving, (e) a graphed fit of whole
    groups against an eager one, (f) fits of partial and phase-straddling
    groups and of megastep_k 1, with validation, graphed against eager,
    bit for bit, (c) the aug experiment's script. Returns the launches of
    the graphed paths."""
    out = {}
    train = _graphs_train(seed, "f32")
    torch.cuda.empty_cache()
    with conv_precision("bf16"):
        train_bf16 = _graphs_train(seed, "bf16")
    torch.cuda.empty_cache()
    out["graphs_train"] = {k: train[k] + train_bf16[k] for k in train}
    work = tempfile.mkdtemp(prefix="radmmm_graphs_")
    try:
        out["graphs_serve"] = _graphs_serve(seed, work)
        torch.cuda.empty_cache()
        out["graphs_fit"] = _graphs_fit(seed, work)
        torch.cuda.empty_cache()
        out["graphs_mixed"] = _graphs_mixed(seed, work, GRAPH_FIT_K,
                                            samples=True)
        torch.cuda.empty_cache()
        out["graphs_plain"] = _graphs_mixed(seed, work, 1)
        torch.cuda.empty_cache()
        _graphs_aug(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


@tf32_off()
def phase_graphs_nccl(seed: int):
    """Part (g): with two cards or more, fit --distributed over NCCL
    graphed against eager (``_graphs_nccl``); returns rank 0's graphed
    launches. With one card a line says that (g) did not run, and it
    returns None (no launches, nothing passed)."""
    if torch.cuda.device_count() < 2:
        log(f"[graphs_nccl] part (g) did not run: it needs NCCL on two "
            f"cards, and this machine has {torch.cuda.device_count()}")
        return None
    work = tempfile.mkdtemp(prefix="radmmm_graphs_nccl_")
    try:
        return _graphs_nccl(seed, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def kernel_entries(rows: list, serve_launches, train_launches,
                   wn_launches, path_launches: dict) -> list:
    """The kernels' JSON entries. K4 forward keeps its serving numbers (one
    B=1 request at text bucket 96 / frame bucket 800 makes one launch at
    each serving shape: the sums of those rows) and lists every shape; K4
    backward sums the four training shapes (one step's launches); K1-K3 and
    K6 are one launch each at the training batch; K5 sums its four
    dilations (one WN stack's launches) and lists each. ``launches`` sums
    the main paths' runs, listed under ``launches_by_path``: serving,
    training and fit (its training steps and validations) for K4 forward,
    the wn phase and fit for K5, training and fit for the rest, and
    ``path_launches``' paths (fit, the vocoder path, which runs none of
    them, radtts_fit, m12, ddp, rank 0's counted steps, caches, its two
    fits, the bf16 phase's training steps, fit and serving, and the graphs
    phase's graphed steps, requests and fits (whole groups, mixed groups,
    megastep_k 1, and rank 0's steps over NCCL), counted through the
    graphs' launch ledger; None for a phase or part not run, and for K6 on
    the paths whose loaders featurize, LOADER_FEATURIZED).
    The bf16 variants of K4 and its backward (rows of the bf16 phase) are
    listed after them the same way, each with the f32 kernel's ms at its
    shapes beside it."""
    def by(kernel, **kw):
        return [r for r in rows if r["kernel"] == kernel
                and all(r.get(k) == v for k, v in kw.items())]

    def summed(rs):
        return {k: sum(r[k] for r in rs)
                for k in ("ms", "plain_ms", "bound_ms", "library_ms")}

    def trained(name):
        return None if train_launches is None else train_launches[name]

    fwd_paths = {"serve": serve_launches,
                 "train": trained("lstm_recurrence")}
    fwd_n = [n for n in fwd_paths.values() if n is not None]
    serve_b1, bwd = by("lstm_recurrence", path="serve", B=1), \
        by("lstm_recurrence_bwd")
    bf16_fwd = by("lstm_recurrence_bf16", path="serve", B=1)
    bf16_bwd = by("lstm_recurrence_bwd_bf16")
    bf16_entries = [] if not bf16_fwd else [
        dict(name="lstm_recurrence_bf16", route="cuda",
             source="radmmm_torch/csrc/lstm_recurrence_bf16.cu",
             replaces="radmmm_tpu/ops/lstm_pallas.py:35",
             max_abs_err=max(r["max_abs_err"]
                             for r in by("lstm_recurrence_bf16")),
             **summed(bf16_fwd),
             f32_ms=sum(r["f32_ms"] for r in bf16_fwd),
             bound_by=max(bf16_fwd, key=lambda r: r["bound_ms"])["bound_by"],
             routes={f"{r['path']} {r['shape']} B={r['B']}": r["route"]
                     for r in by("lstm_recurrence_bf16")},
             shapes=by("lstm_recurrence_bf16")),
        dict(name="lstm_recurrence_bwd_bf16", route="cuda",
             source="radmmm_torch/csrc/lstm_recurrence_bf16.cu",
             replaces="radmmm_tpu/ops/lstm.py:103",
             max_abs_err=max(r["max_abs_err"] for r in bf16_bwd),
             **summed(bf16_bwd), f32_ms=sum(r["f32_ms"] for r in bf16_bwd),
             bound_by=max(bf16_bwd, key=lambda r: r["bound_ms"])["bound_by"],
             shapes=bf16_bwd)]

    def finish(entries):
        for e in entries:
            paths = dict(e.get("launches_by_path") or (
                {"wn": wn_launches} if e["name"] == "conv_softplus"
                else {} if e["name"].endswith("_bf16")
                else {"train": trained(e["name"])}))
            for path, counts in path_launches.items():
                paths[path] = None if counts is None else counts.get(
                    e["name"])
            counts = [n for n in paths.values() if n is not None]
            e["launches"] = sum(counts) if counts else None
            e["launches_by_path"] = paths
        return entries

    if not by("lstm_recurrence"):    # only the bf16 phase ran
        return finish(bf16_entries)
    entries = [
        dict(name="lstm_recurrence", route="cuda",
             source="radmmm_torch/csrc/lstm_recurrence.cu",
             replaces="radmmm_tpu/ops/lstm_pallas.py:35",
             launches=sum(fwd_n) if fwd_n else None,
             launches_by_path=fwd_paths,
             max_abs_err=max(r["max_abs_err"]
                             for r in by("lstm_recurrence")),
             **summed(serve_b1),
             bound_by=max(serve_b1, key=lambda r: r["bound_ms"])["bound_by"],
             routes={f"{r['path']} {r['shape']} B={r['B']}": r["route"]
                     for r in by("lstm_recurrence")},
             shapes=by("lstm_recurrence")),
        # no Pallas counterpart: the JAX package differentiates the scan
        dict(name="lstm_recurrence_bwd", route="cuda",
             source="radmmm_torch/csrc/lstm_recurrence_bwd.cu",
             replaces="radmmm_tpu/ops/lstm.py:103",
             launches=trained("lstm_recurrence_bwd"),
             max_abs_err=max(r["max_abs_err"] for r in bwd), **summed(bwd),
             bound_by=max(bwd, key=lambda r: r["bound_ms"])["bound_by"],
             shapes=bwd)]
    for name, source in (("ctc_alpha", "radmmm_torch/csrc/ctc_band_dp.cu"),
                         ("ctc_beta", "radmmm_torch/csrc/ctc_band_dp.cu"),
                         ("mas_width1", "radmmm_torch/csrc/mas_width1.cu")):
        (r,) = by(name)
        entries.append(dict(name=name, route="cuda", source=source,
                            replaces=r["src"], launches=trained(name),
                            **{k: r[k] for k in (
                                "max_abs_err", "ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}))
    k5 = by("conv_softplus")
    entries.append(dict(
        name="conv_softplus", route="cuda",
        source="radmmm_torch/csrc/conv_softplus.cu",
        replaces="scripts/bench_wn_kernel.py:133", launches=wn_launches,
        max_abs_err=max(r["max_abs_err"] for r in k5), **summed(k5),
        bound_by=max(k5, key=lambda r: r["bound_ms"])["bound_by"],
        shapes=k5))
    (k6,) = by("pyin_viterbi")
    entries.append(dict(
        name="pyin_viterbi", route="cuda",
        source="radmmm_torch/csrc/pyin_viterbi.cu", replaces=k6["src"],
        **{k: k6[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "cluster")}))
    # K7: its numbers at the flagship's in_0 (B 8 x T/2 256, 1,024 -> 1,024,
    # K 5), every shape's row listed
    for name in ("wn_conv_fwd", "wn_conv_dgrad", "wn_conv_wgrad"):
        k7 = by(name)
        (flag,) = by(name, cell="train", conv="in_0")
        entries.append(dict(
            name=name, route="cuda",
            source="radmmm_torch/csrc/wn_conv_f32.cu",
            replaces="none: XLA's conv1d_same (radmmm_tpu/ops/conv.py)",
            max_abs_err=max(r["max_abs_err"] for r in k7),
            **{k: flag[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "peak_share",
                                    "padded_share")},
            shapes=k7))
    entries[2:2] = bf16_entries
    return finish(entries)


def main() -> int:
    # the ddp phase's children: chip_smoke.py --ddp-child SPEC RANK and
    # --e2e-child SPEC RANK, and under torchrun chip_smoke.py
    # --ddp-fit-child DIR -- CLI-ARGS
    if sys.argv[1:2] == ["--ddp-child"]:
        return ddp_child(sys.argv[2], int(sys.argv[3]))
    if sys.argv[1:2] == ["--ddp-fit-child"]:
        i = sys.argv.index("--")
        return ddp_fit_child(sys.argv[2], sys.argv[i + 1:], sys.argv[3:i])
    if sys.argv[1:2] == ["--e2e-child"]:
        return e2e_child(sys.argv[2], int(sys.argv[3]))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs only on the card")
        return 2
    # outside a checkout of the repository this import fails
    from radmmm_torch.utils.device import card_line

    t_start = time.perf_counter()
    rows, serve_launches, train_launches, wn_launches = [], None, None, None
    train_ms = None
    fit_launches = vocoder_launches = vocoder_run = None
    radtts_launches = m12_launches = ddp_launches = caches_launches = None
    bf16_launches = {}
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
            serve_launches = phase_serve(args.seed, model, vocoder,
                                         model_gpu)
        if "parity" in phases:
            phase_parity(args.seed, model, model_gpu)
        del model, vocoder, model_gpu
    if "train" in phases:
        train_launches, train_ms = phase_train(args.seed)
    if "train_parity" in phases:
        phase_train_parity(args.seed)
    if "wn" in phases:
        wn_launches = phase_wn()
    if "featurize" in phases:
        phase_featurize(args.seed)
    work = tempfile.mkdtemp(prefix="radmmm_vocoder_")
    try:
        if "vocoder" in phases:
            voc = phase_vocoder(args.seed, work)
            vocoder_launches, vocoder_run = voc["launches"], voc["run_dir"]
        if "fit" in phases:
            fit_launches = phase_fit(
                args.seed, "fit", RECIPE, FIT_SR,
                lambda root: recipe_overlay(root, args.seed, vocoder_run),
                recipe_prompts, vocoder_run)["fit"]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if "radtts_fit" in phases:
        radtts_launches = phase_fit(
            args.seed, "radtts_fit", RADTTS_STACK, RADTTS_SR,
            lambda root: radtts_overlay(root, args.seed),
            radtts_prompts)["fit"]
    if "m12" in phases:
        m12_launches = phase_m12(args.seed)
    if "ddp" in phases:
        ddp_launches = phase_ddp(args.seed)
    if "caches" in phases:
        caches_launches = phase_caches(args.seed)
    if "bf16" in phases:
        bf16_rows, bf16_launches = phase_bf16(args.seed, train_ms)
        rows = rows + bf16_rows
    graph_launches = {}
    if "graphs" in phases:
        graph_launches = phase_graphs(args.seed)
    if "graphs_nccl" in phases:
        graph_launches["graphs_nccl"] = phase_graphs_nccl(args.seed)
    if rows:
        log(json.dumps({"kernels": kernel_entries(
            rows, serve_launches, train_launches, wn_launches,
            {"fit": fit_launches, "vocoder": vocoder_launches,
             "radtts_fit": radtts_launches, "m12": m12_launches,
             "ddp": ddp_launches, "caches": caches_launches,
             **{f"bf16_{k}": bf16_launches.get(k)
                for k in ("train", "fit", "serve")},
             **{k: graph_launches.get(k)
                for k in ("graphs_train", "graphs_serve", "graphs_fit",
                          "graphs_mixed", "graphs_plain",
                          "graphs_nccl")}})}))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
