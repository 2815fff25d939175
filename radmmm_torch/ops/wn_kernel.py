"""The fused dilated conv1d + bias + softplus of the WN stack: the CUDA
kernel wrapper, its plain PyTorch twin and its launch counter.

Counterpart of ``pallas_conv_softplus`` in ``scripts/bench_wn_kernel.py``
(a Pallas kernel that lives in that measurement script; the package's WN
layers do not call it). ``conv_softplus(x, w, b, dilation)`` takes x
(B, T, Cin) of any float dtype, cast to bf16, w (K, Cin, Cout) in the
script's WIO layout, cast to bf16, and b (Cout,) f32, and returns
(B, T, Cout) f32::

    out[b, t, o] = softplus(b[o] + sum_i sum_c x[b, t + (i - K//2) d, c]
                                               * w[i, c, o])

with x zero outside [0, T), f32 accumulation and softplus in the stable
form of ``jax.nn.softplus``, max(v, 0) + log1p(exp(-|v|)) (not
``F.softplus``, which switches to the identity above 20). K is odd, so the
padding d (K - 1) / 2 is the same on both sides. Forward only, as in the
script.

CPU tensors run ``conv_softplus_reference``; CUDA tensors launch
``csrc/conv_softplus.cu`` (built by ``utils/cuda_build``) or raise. The
kernel is CUDA C++ rather than Triton: it is a tensor-core GEMM (wgmma fed
by TMA) with a data-dependent halo, not a fused elementwise pass. It reads
x and w in their own layouts, so the wrapper's only copies are the bf16
casts of operands that are not bf16 yet.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launched

# the TMA tensor maps need 16-byte row strides: 8 bf16 channels
CHANNEL_MULTIPLE = 8


def softplus(v: torch.Tensor) -> torch.Tensor:
    """The stable softplus of ``jax.nn.softplus``: max(v, 0) +
    log1p(exp(-|v|)), exact for every v."""
    return torch.clamp_min(v, 0.0) + torch.log1p(torch.exp(-v.abs()))


def conv_softplus_reference(x: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, dilation: int) -> torch.Tensor:
    """Plain twin: x and w rounded to bf16, then an f32 conv1d with padding
    d (K - 1) / 2 and dilation d, the bias and the stable softplus."""
    K = w.shape[0]
    xb = x.to(torch.bfloat16).float().transpose(1, 2)        # (B, Cin, T)
    wb = w.to(torch.bfloat16).float().permute(2, 1, 0)       # (Cout, Cin, K)
    y = F.conv1d(xb, wb, padding=dilation * (K - 1) // 2, dilation=dilation)
    return softplus(y.transpose(1, 2) + b.float())


def _check(x, w, b, dilation):
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"conv_softplus: x must be (B, T, Cin) and w "
                         f"(K, Cin, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    K, Cin, Cout = w.shape
    if x.shape[2] != Cin or b.shape != (Cout,):
        raise ValueError(f"conv_softplus: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and b {tuple(b.shape)} do not "
                         "agree on the channels")
    if not (x.is_floating_point() and w.is_floating_point()
            and b.is_floating_point()):
        raise TypeError("conv_softplus: x, w and b must be float tensors")
    if K % 2 == 0 or int(dilation) < 1:
        raise ValueError(f"conv_softplus: needs an odd kernel size and a "
                         f"dilation >= 1, got K={K}, dilation={dilation}")
    if Cin % CHANNEL_MULTIPLE or Cout % CHANNEL_MULTIPLE:
        raise ValueError(f"conv_softplus: the kernel takes channel counts "
                         f"that are multiples of {CHANNEL_MULTIPLE}, got "
                         f"Cin={Cin}, Cout={Cout}")
    if not x.device == w.device == b.device:
        raise ValueError(f"conv_softplus: x on {x.device}, w on {w.device}, "
                         f"b on {b.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"conv_softplus: no kernel for device {x.device}")


def _aligned_bf16(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous bf16 whose data starts on a 16-byte boundary (the
    kernel's TMA tensor maps need that base)."""
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv_softplus(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  dilation: int) -> torch.Tensor:
    """softplus(conv1d(x, w, dilation) + b), (B, T, Cout) f32."""
    _check(x, w, b, dilation)
    if x.device.type == "cpu":
        return conv_softplus_reference(x, w, b, dilation)
    B, T, Cin = x.shape
    K, _, Cout = w.shape
    out = torch.empty((B, T, Cout), dtype=torch.float32, device=x.device)
    if B * T == 0:
        return out
    xb, wb = _aligned_bf16(x), _aligned_bf16(w)
    bf = b.float().contiguous()
    lib = cuda_build.load("conv_softplus", _declare)
    with torch.cuda.device(x.device):
        err = lib.conv_softplus_launch(
            xb.data_ptr(), wb.data_ptr(), bf.data_ptr(), out.data_ptr(), B,
            T, Cin, Cout, K, int(dilation),
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "conv_softplus")
    launched("conv_softplus")
    return out


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.conv_softplus_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                         ci, vp]
    lib.conv_softplus_launch.restype = ci
