"""The WN stack's f32 convolutions through one hand-written CUDA kernel
(K7, ``csrc/wn_conv_f32.cu``): its wrappers, plain twins, the autograd
function that joins them, and the shape plan.

``conv(module, x, mask)`` is what ``ops/coupling.py`` ``WN`` calls for its
``start``, ``in_i``, ``res_skip_i`` and ``end``. In f32 conv precision, on
a CUDA tensor, it runs the module's convolution as ``_WNConvF32``: the
forward through the kernel's forward, the backward through its dgrad and
wgrad, with ``weight_norm_kernel``'s output permuted to the layouts they
read; a module it cannot take there (an even kernel, a padding other than
the centred one) raises. Otherwise (the CPU, bf16 mode) it calls the
module, whose arithmetic (``conv.masked_conv1d``) is the twin.

The kernel's contract, for x (B, T, C_in) and w (K, C_in, C_out)
(``conv_f32``, twin ``conv_reference``)::

    raw[b, t, o] = sum_k sum_c w[k, c, o] x[b, t + (k - (K-1)/2) d, c]

with x zero outside [0, T) and, with ``premask``, where the mask is 0; then
``MaskedConv1d.forward``'s epilogue (partial padding: the mask's count over
the taps, ratio K / (count + 1e-6), the count clipped to [0, 1], the bias
times the clip; else the bias), times the mask where one is given.
``wgrad_f32`` (twin ``wgrad_reference``) is that convolution's weight
gradient in (K, C_out, C_in). The kernel reads the mask as 0 or not 0, as
the port's masks from lengths are. Both run their reductions in a fixed
order, so two runs give the same bits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from radmmm_torch.ops.conv import get_conv_precision, masked_conv1d
from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launched

# the kernel's tile (rows x channels), stage depth (kBK in
# csrc/wn_conv_f32.cu), and the multiple its channel counts take (16-byte
# rows)
TILE = 128
STAGE = 32
CHANNEL_MULTIPLE = 4
# rows of one wgrad split that the kernel describes in shared memory
MAX_SPLIT_ROWS = 2048
MAX_SPLITS = 32
# the plan's cost model, from the kernel's times on the H100 (PERF.md
# section 6, K7): a 128 x 128 x 32 stage on an SM, the partials' round
# trip at this bandwidth, and the reduction's launch
STAGE_S = 3.1e-6
BYTES_PER_S = 2.5e12
REDUCE_S = 3e-6


def conv_reference(x, wt, bias, mask, dilation: int, premask: bool,
                   pp: bool) -> torch.Tensor:
    """Plain twin of the kernel's forward: ``masked_conv1d`` on w in its
    (C_out, C_in, K) layout."""
    K = wt.shape[0]
    return masked_conv1d(x, wt.permute(2, 1, 0), bias, mask,
                         dilation * (K - 1) // 2, dilation, pp, premask)


def row_scales_reference(mask, B: int, T: int, K: int, dilation: int,
                         pp: bool, dtype, device=None) -> torch.Tensor:
    """(B T, 2): a row's factor of the output gradient (the partial-padding
    scale times the mask) and of the bias gradient (the clipped count
    times the mask), as the kernel's forward writes them."""
    if pp:
        m = (mask if mask is not None
             else torch.ones((1, T), dtype=dtype, device=device))
        upd = F.conv1d(m[:, None, :], m.new_ones((1, 1, K)),
                       padding=dilation * (K - 1) // 2,
                       dilation=dilation)[:, 0]
        ratio = K / (upd + 1e-6)
        clip = upd.clamp(0.0, 1.0)
        s0, s1 = ratio * clip, clip
        if mask is not None:
            s0, s1 = s0 * mask, s1 * mask
    else:
        s0 = s1 = mask
    return torch.stack([s0, s1], dim=-1).expand(B, T, 2).reshape(B * T, 2)


def wgrad_reference(dy, x, mask, K: int, dilation: int) -> torch.Tensor:
    """Plain twin of the kernel's wgrad: the weight gradient (K, C_out,
    C_in) of the convolution of x (times the mask, where given) whose
    output gradient is dy (B, T, C_out)."""
    if mask is not None:
        x = x * mask[..., None]
    dw = torch.nn.grad.conv1d_weight(
        x.transpose(1, 2), (dy.shape[2], x.shape[2], K), dy.transpose(1, 2),
        padding=dilation * (K - 1) // 2, dilation=dilation)
    return dw.permute(2, 0, 1)


def conv_splits(N: int, C_in: int, C_out: int, K: int, sms: int) -> int:
    """Splits of the forward's (or dgrad's) reduction: the fewest whose
    waves of tiles, each as long as its share of the taps x channel
    stages, plus the partials' round trip, take the least time."""
    tiles = math.ceil(N / TILE) * math.ceil(C_out / TILE)
    stages = K * math.ceil(C_in / STAGE)
    return _best_split(tiles, stages, N * C_out, sms)


def wgrad_splits(N: int, C_in: int, C_out: int, K: int,
                 sms: int) -> Tuple[int, int]:
    """(splits, rows a split) of the wgrad's reduction over the N rows;
    rows a split a multiple of STAGE and at most MAX_SPLIT_ROWS."""
    tiles = math.ceil(C_out / TILE) * math.ceil(C_in / TILE) * K
    stages = math.ceil(N / STAGE)
    s = max(_best_split(tiles, stages, K * C_out * C_in, sms),
            math.ceil(N / MAX_SPLIT_ROWS))
    rows = math.ceil(math.ceil(N / s) / STAGE) * STAGE
    return math.ceil(N / rows), rows


def _best_split(tiles: int, stages: int, out_elems: int, sms: int) -> int:
    def cost(s):
        t = math.ceil(tiles * s / sms) * math.ceil(stages / s) * STAGE_S
        if s > 1:
            t += s * out_elems * 8 / BYTES_PER_S + REDUCE_S
        return t
    top = max(1, min(MAX_SPLITS, stages // 4))
    return min(range(1, top + 1), key=lambda s: (cost(s), s))


def _sm_count(dev: torch.device) -> int:
    return _sms(dev.index if dev.index is not None
                else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(what: str, *tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {dev}")
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: the kernel takes float32, got {t.dtype}")


def _padded(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t contiguous, zero-padded along ``dim`` to a multiple of
    CHANNEL_MULTIPLE, its data on a 16-byte boundary (the kernel's rows are
    16-byte copies)."""
    extra = -t.shape[dim] % CHANNEL_MULTIPLE
    if extra:
        pad = [0, 0] * (t.dim() - 1 - dim % t.dim()) + [0, extra]
        t = F.pad(t, pad)
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _lib():
    return cuda_build.load("wn_conv_f32", _declare)


def conv_f32(x, wt, bias, mask, dilation: int, premask: bool, pp: bool,
             row_scales: bool = False, name: str = "wn_conv_fwd"
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's forward (dgrad with ``name="wn_conv_dgrad"``): x (B,
    T, C_in), wt (K, C_in, C_out), bias (C_out,) or None, mask (B, T) f32
    or None -> ((B, T, C_out), the (B T, 2) row scales when
    ``row_scales``, else None)."""
    B, T, C_in = x.shape
    K, _, C_out = wt.shape
    if K % 2 == 0 or dilation < 1:
        raise ValueError(f"{name}: needs an odd kernel and a dilation >= 1")
    _check(name, x, wt, bias, mask)
    if mask is not None:
        mask = mask.contiguous()
    x, wt = _padded(x, 2), _padded(_padded(wt, 1), 2)
    if bias is not None:
        bias = _padded(bias, 0)
    cin, cout = x.shape[2], wt.shape[2]
    if wt.shape[1] != cin or (bias is not None and bias.shape != (cout,)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(wt.shape)} "
                         "and the bias do not agree on the channels")
    N = B * T
    out = torch.empty((B, T, cout), dtype=torch.float32, device=x.device)
    rs = (torch.empty((N, 2), dtype=torch.float32, device=x.device)
          if row_scales else None)
    splits = conv_splits(N, cin, cout, K, _sm_count(x.device))
    part = (torch.empty((splits, N, cout), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.wn_conv_launch(
            _ptr(x), _ptr(wt), _ptr(bias), _ptr(mask), _ptr(out), _ptr(rs),
            _ptr(part), B, T, cin, cout, K, int(dilation), int(premask),
            int(pp), splits, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, name)
    launched(name)
    return (out if cout == C_out else out[..., :C_out]), rs


def wgrad_f32(dy, x, mask, K: int, dilation: int) -> torch.Tensor:
    """The kernel's wgrad: dy (B, T, C_out), x (B, T, C_in), mask (B, T)
    f32 or None (x rows where it is 0 read as zeros) -> (K, C_out, C_in)."""
    B, T, C_out = dy.shape
    C_in = x.shape[2]
    if x.shape[:2] != (B, T) or K % 2 == 0 or dilation < 1:
        raise ValueError(f"wn_conv_wgrad: dy {tuple(dy.shape)}, x "
                         f"{tuple(x.shape)}, K {K}, dilation {dilation}")
    _check("wn_conv_wgrad", dy, x, mask)
    if mask is not None:
        mask = mask.contiguous()
    dy, x = _padded(dy, 2), _padded(x, 2)
    cin, cout = x.shape[2], dy.shape[2]
    N = B * T
    splits, rows = wgrad_splits(N, cin, cout, K, _sm_count(x.device))
    out = torch.empty((K, cout, cin), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, K, cout, cin), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.wn_wgrad_launch(
            _ptr(dy), _ptr(x), _ptr(mask), _ptr(out), _ptr(part), B, T, cin,
            cout, K, int(dilation), splits, rows,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, "wn_conv_wgrad")
    launched("wn_conv_wgrad")
    return out if (cin, cout) == (C_in, C_out) else out[:, :C_out, :C_in]


class _WNConvF32(torch.autograd.Function):
    """``masked_conv1d`` in f32 through the kernel: x (B, T, C_in), w
    (C_out, C_in, K) (``weight_norm_kernel``'s output), bias or None, mask
    (B, T) f32 or None. The backward: draw = dout times the forward's row
    scale; dx by the dgrad (taps reversed, w[k] transposed, the premask on
    its output), dw by the wgrad (x masked as it loads), the bias gradient
    as dout against the rows' clipped counts."""

    @staticmethod
    def forward(ctx, x, w, bias, mask, dilation, pp, premask):
        x = x.contiguous()
        C_out, _, K = w.shape
        grads = any(ctx.needs_input_grad[:3])
        out, rs = conv_f32(x, w.permute(2, 1, 0), bias, mask, dilation,
                           premask, pp,
                           row_scales=grads and (pp or mask is not None))
        ctx.save_for_backward(x, w, mask, rs)
        ctx.conf = (K, dilation, pp, premask, bias is not None)
        return out[..., :C_out]

    @staticmethod
    def backward(ctx, dout):
        x, w, mask, rs = ctx.saved_tensors
        K, dilation, pp, premask, has_bias = ctx.conf
        B, T, C_out = dout.shape
        dout = dout.contiguous()
        draw = dout if rs is None else dout * rs[:, :1].view(B, T, 1)
        premasked = mask if (premask or pp) else None
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            wd = w.flip(2) if K > 1 else w
            dx, _ = conv_f32(draw, wd.permute(2, 0, 1), None, premasked,
                             dilation, False, False, name="wn_conv_dgrad")
            dx = dx[..., :x.shape[2]]
        if ctx.needs_input_grad[1]:
            dw = wgrad_f32(draw, x, premasked, K, dilation).permute(1, 2, 0)
        if has_bias and ctx.needs_input_grad[2]:
            d2 = dout.view(B * T, C_out)
            db = d2.sum(0) if rs is None else d2.t().mv(rs[:, 1])
        return dx, dw, db, None, None, None, None


def _routes_to_kernel(module, x: torch.Tensor) -> bool:
    """The module's convolution of x goes through the kernel: a CUDA f32
    tensor in f32 conv precision."""
    return (x.is_cuda and x.dtype == torch.float32
            and get_conv_precision() == "f32")


def conv(module, x: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``module(x, mask)`` for a ``MaskedConv1d`` of a WN stack, through
    the kernel where ``_routes_to_kernel`` says so; a module whose padding
    is not its kernel's centred one raises there."""
    if not _routes_to_kernel(module, x):
        return module(x, mask)
    if module.padding != module.dilation * (module.kernel_size - 1) // 2:
        raise ValueError(f"wn_conv: padding {module.padding} is not the "
                         f"centred one of kernel {module.kernel_size} at "
                         f"dilation {module.dilation}")
    fmask = None if mask is None else mask.to(x.dtype).contiguous()
    return _WNConvF32.apply(x, module.kernel(), module.bias, fmask,
                            module.dilation, module.use_partial_padding,
                            module.premask_input)


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.wn_conv_launch.argtypes = [vp] * 7 + [ci] * 9 + [vp]
    lib.wn_conv_launch.restype = ci
    lib.wn_wgrad_launch.argtypes = [vp] * 5 + [ci] * 8 + [vp]
    lib.wn_wgrad_launch.restype = ci
