"""Microbenchmark of the WN coupling-stack conv on the card: three ways to
run the 4-layer dilated conv stack of a WN coupling.

    python -m radmmm_torch.scripts.bench_wn_kernel [--batch 32] [--t 256]
                                                   [--iters 30]
                                                   [--device cuda]

The port's counterpart of ``scripts/bench_wn_kernel.py``. At the flagship
shape (B 32, T 256 after the squeeze, C 1024, k 5, dilations 1/2/4/8,
softplus, 4 layers with a 1x1 res_skip each):

  A  ``conv_cudnn``: F.conv1d in bf16 with a bf16 output (cuDNN on the
     card), cast to f32, as the script's ``conv_lax`` rounds;
  B  ``conv_matmul``: the conv as K shifted bf16 matmuls, summed in bf16;
  C  ``wn_stack_fused``: the fused dilated conv + bias + softplus kernel
     (``ops/wn_kernel.conv_softplus``, forward only) for each layer, the
     1x1 res_skip a bf16 matmul.

Each is timed forward; A and B also as loss and gradients with respect to
the parameters through autograd (C has no backward). ``make_params`` draws
the same numbers from the same seeded numpy generator as the script, so
the weights are identical. Prints the parity line, a table with each
variant's TFLOP/s and its share of the card's bf16 dense tensor-core peak,
the card's name and power limit, and a JSON line. With ``--device cuda``
and no card it raises.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from radmmm_torch.ops.wn_kernel import conv_softplus, softplus
from radmmm_torch.utils.device import card_line, resolve_device

C = 1024
K = 5
DILATIONS = (1, 2, 4, 8)
# NVIDIA H100 SXM bf16 dense tensor-core peak at 700 W (data sheet)
BF16_DENSE_PEAK = 989e12

Params = List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def stack_flops(B: int, T: int, n_layers: int = 4) -> int:
    """Forward operations of the stack: per layer a k=5 conv C -> C and a
    1x1 res_skip C -> C, 2 per multiply-add."""
    return n_layers * (2 * K * C * C + 2 * C * C) * B * T


def make_params(rng: np.random.Generator, device="cpu") -> Params:
    """(wc (K, C, C), bc, wr (C, C), br) per dilation, f32, drawn in the
    script's order from ``rng``."""
    ps = []
    for _ in DILATIONS:
        wc = rng.standard_normal((K, C, C)) * 0.02
        wr = rng.standard_normal((C, C)) * 0.02
        ps.append(tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                        for a in (wc, np.zeros(C), wr, np.zeros(C))))
    return ps


def make_inputs(B: int, T: int, device) -> Tuple[Params, torch.Tensor]:
    """The script's parameters and input x (B, T, C) from seed 0."""
    rng = np.random.default_rng(0)
    params = make_params(rng, device)
    x = torch.from_numpy(
        rng.standard_normal((B, T, C)).astype(np.float32)).to(device)
    return params, x


def conv_cudnn(x: torch.Tensor, w: torch.Tensor, dilation: int):
    """Variant A: F.conv1d of bf16 x (B, T, Cin) and w (K, Cin, Cout) with
    a bf16 output, as f32 (B, T, Cout)."""
    pad = dilation * (K - 1) // 2
    y = F.conv1d(x.to(torch.bfloat16).transpose(1, 2),
                 w.to(torch.bfloat16).permute(2, 1, 0), padding=pad,
                 dilation=dilation)
    return y.transpose(1, 2).float()


def conv_matmul(x: torch.Tensor, w: torch.Tensor, dilation: int):
    """Variant B: K shifted bf16 matmuls, each tap rounded to bf16 and the
    taps summed in bf16, as f32."""
    pad = dilation * (K - 1) // 2
    T = x.shape[1]
    xb = F.pad(x.to(torch.bfloat16), (0, 0, pad, pad))
    wb = w.to(torch.bfloat16)
    out = None
    for i in range(K):
        tap = torch.matmul(xb[:, i * dilation:i * dilation + T], wb[i])
        out = tap if out is None else out + tap
    return out.float()


def _res_skip(h, wr, br):
    return softplus(torch.matmul(h.to(torch.bfloat16),
                                 wr.to(torch.bfloat16)).float() + br)


def wn_stack(conv_fn: Callable, params: Params, x: torch.Tensor):
    """The WN hot loop (WN's forward minus its start and end convs) with
    ``conv_fn`` as the dilated conv. Returns (h, skip)."""
    h, skip = x, torch.zeros_like(x)
    for (wc, bc, wr, br), d in zip(params, DILATIONS):
        h = softplus(conv_fn(h, wc, d) + bc)
        skip = skip + _res_skip(h, wr, br)
    return h, skip


def wn_stack_fused(params: Params, x: torch.Tensor):
    """Variant C: the fused conv + softplus kernel for each dilated conv
    (4 launches on the card)."""
    h, skip = x, torch.zeros_like(x)
    for (wc, bc, wr, br), d in zip(params, DILATIONS):
        h = conv_softplus(h, wc, bc, d)
        skip = skip + _res_skip(h, wr, br)
    return h, skip


def _seconds(fn: Callable, iters: int, device: torch.device) -> float:
    """Mean seconds of ``fn`` after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def run(params: Params, x: torch.Tensor, iters: int) -> dict:
    """Parity of B and C against A, then every variant timed; prints the
    parity line and the table and returns the results (times in ms,
    TFLOP/s, the parity errors and the device)."""
    device = x.device
    B, T, _ = x.shape
    on_card = device.type == "cuda"
    fwd_flops = stack_flops(B, T)
    grad_flops = 3 * fwd_flops          # forward + data and weight grads

    with torch.no_grad():
        hA, sA = wn_stack(conv_cudnn, params, x)
        hB, _ = wn_stack(conv_matmul, params, x)
        hC, sC = wn_stack_fused(params, x)
    results = {
        "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "err_A_B_h": (hA - hB).abs().max().item(),
        "err_A_C_h": (hA - hC).abs().max().item(),
        "err_A_C_skip": (sA - sC).abs().max().item(),
        "max_A_h": hA.abs().max().item(),
        "max_A_skip": sA.abs().max().item()}
    print(f"max|A-B| = {results['err_A_B_h']:.3e}   max|A-C| = "
          f"{results['err_A_C_h']:.3e} (skip {results['err_A_C_skip']:.3e})",
          flush=True)

    rows = []
    variants: Sequence[Tuple[str, Callable]] = (
        ("A_cudnn_conv", lambda p, v: wn_stack(conv_cudnn, p, v)),
        ("B_shift_matmul", lambda p, v: wn_stack(conv_matmul, p, v)),
        ("C_cuda_fused", wn_stack_fused))
    for name, fn in variants:
        with torch.no_grad():
            s = _seconds(lambda: fn(params, x), iters, device)
        rows.append((f"fwd  {name}", s, fwd_flops))
        results[f"wn_fwd_{name}_ms"] = s * 1e3
        results[f"wn_fwd_{name}_tfs"] = fwd_flops / s / 1e12

    leaves = [p.detach().requires_grad_() for layer in params for p in layer]
    grad_params = [tuple(leaves[i:i + 4]) for i in range(0, len(leaves), 4)]
    for name, conv_fn in (("A_cudnn_conv", conv_cudnn),
                          ("B_shift_matmul", conv_matmul)):
        def value_and_grad():
            h, skip = wn_stack(conv_fn, grad_params, x)
            loss = (h * h).sum() + (skip * skip).sum()
            return loss, torch.autograd.grad(loss, leaves)
        s = _seconds(value_and_grad, iters, device)
        rows.append((f"grad {name}", s, grad_flops))
        results[f"wn_grad_{name}_ms"] = s * 1e3
        results[f"wn_grad_{name}_tfs"] = grad_flops / s / 1e12

    print(f"\nWN 4-layer stack, B={B} T={T} C={C} k={K} d={DILATIONS}, "
          f"fwd {fwd_flops / 1e9:.1f} GF, on {results['device']}")
    if on_card:
        print(f"card: {card_line()}; %peak of the H100 SXM bf16 dense "
              f"tensor-core peak, {BF16_DENSE_PEAK / 1e12:.0f} TFLOP/s")
    print(f"{'variant':24s} {'ms':>9s} {'TF/s':>7s} {'%peak':>6s}")
    for name, s, flops in rows:
        tf = flops / s / 1e12
        peak = f"{tf * 1e12 / BF16_DENSE_PEAK:6.1%}" if on_card else "     -"
        print(f"{name:24s} {s * 1e3:9.3f} {tf:7.1f} {peak}")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--t", type=int, default=256)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params, x = make_inputs(args.batch, args.t, device)
    results = run(params, x, args.iters)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
