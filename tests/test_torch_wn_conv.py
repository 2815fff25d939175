"""K7, the WN stack's f32 convolutions (``ops/wn_conv.py``), on the CPU.

The kernel runs on the card alone, so these tests hold its plain twins:
the twin of the forward against a convolution written out tap by tap in
float64; the twin of the wgrad against autograd; the autograd function that
composes forward, dgrad and wgrad (taps reversed, row scales, premask),
with the kernel's entry points swapped for the twins (``twins``), against
float64 finite differences (``gradcheck``); a WN stack through that
function against the same stack through its modules; the wrapper's refusals;
and its split plan at the shapes the cells run. Small widths: the whole
file takes a few seconds.
"""
import math

import pytest
import torch

from radmmm_torch.ops import wn_conv
from radmmm_torch.ops.conv import MaskedConv1d
from radmmm_torch.ops.coupling import WN
from tests.test_torch_threads import one_torch_thread  # noqa: F401

B, T = 3, 11


@pytest.fixture
def twins(monkeypatch):
    """The kernel's entry points (``conv_f32``, ``wgrad_f32``) replaced by
    their twins, with their signatures, so ``_WNConvF32`` runs on the
    CPU."""
    def conv_f32(x, wt, bias, mask, dilation, premask, pp,
                 row_scales=False, name="wn_conv_fwd"):
        out = wn_conv.conv_reference(x, wt, bias, mask, dilation, premask,
                                     pp)
        rs = (wn_conv.row_scales_reference(mask, x.shape[0], x.shape[1],
                                           wt.shape[0], dilation, pp,
                                           x.dtype)
              if row_scales else None)
        return out, rs

    monkeypatch.setattr(wn_conv, "conv_f32", conv_f32)
    monkeypatch.setattr(wn_conv, "wgrad_f32", wn_conv.wgrad_reference)


def _mask(kind: str, dtype=torch.float64):
    """None, ragged prefixes, a mask that is not a prefix, or items of
    length 1 (one of them at the last frame)."""
    if kind == "none":
        return None
    m = torch.zeros((B, T), dtype=dtype)
    if kind == "ragged":
        for b, n in enumerate((T, 7, 2)):
            m[b, :n] = 1
    elif kind == "holes":
        m[:] = 1
        m[0, 3:5] = 0
        m[1, 0] = 0
        m[2, ::3] = 0
    else:                                    # "length1"
        m[0, 0] = 1
        m[1, T - 1] = 1
        m[2, 5] = 1
    return m


def _tap_by_tap(x, w, bias, mask, dilation, pp):
    """MaskedConv1d's definition, written out over the taps in float64:
    (the output, its (B, T) factors of raw and of the bias)."""
    K = w.shape[2]
    half = (K - 1) // 2
    m = mask if mask is not None else torch.ones(x.shape[:2],
                                                 dtype=x.dtype)
    xp = x * m[..., None] if (mask is not None) else x
    raw = torch.zeros(x.shape[0], x.shape[1], w.shape[0], dtype=x.dtype)
    upd = torch.zeros(x.shape[:2], dtype=x.dtype)
    for k in range(K):
        off = (k - half) * dilation
        for t in range(x.shape[1]):
            if 0 <= t + off < x.shape[1]:
                raw[:, t] += xp[:, t + off] @ w[:, :, k].t()
                upd[:, t] += m[:, t + off]
    scale = bscale = torch.ones_like(upd)
    if pp:
        bscale = upd.clamp(0, 1)
        scale = K / (upd + 1e-6) * bscale
    out = raw * scale[..., None]
    if bias is not None:
        out = out + bias * bscale[..., None]
    return out * m[..., None], scale * m, bscale * m


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "holes", "length1"])
@pytest.mark.parametrize("K,dilation", [(1, 1), (5, 1), (5, 2), (5, 4),
                                        (5, 8)])
@pytest.mark.parametrize("pp", [True, False])
def test_twin_matches_the_taps(mask_kind, K, dilation, pp):
    g = torch.Generator().manual_seed(K * 100 + dilation)
    x = torch.randn((B, T, 6), generator=g, dtype=torch.float64)
    w = torch.randn((5, 6, K), generator=g, dtype=torch.float64)
    bias = torch.randn((5,), generator=g, dtype=torch.float64)
    mask = _mask(mask_kind)
    want, scale, bscale = _tap_by_tap(x, w, bias, mask, dilation, pp)
    got = wn_conv.conv_reference(x, w.permute(2, 1, 0), bias, mask,
                                 dilation, True, pp)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    if pp or mask is not None:
        rs = wn_conv.row_scales_reference(mask, B, T, K, dilation, pp,
                                          x.dtype)
        torch.testing.assert_close(rs.view(B, T, 2),
                                   torch.stack([scale, bscale], -1),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("mask_kind", ["none", "ragged", "holes"])
def test_twin_is_the_module(mask_kind, one_torch_thread):
    """On the CPU, ``conv`` is the module's own arithmetic, bit for bit."""
    torch.manual_seed(0)
    for m in (MaskedConv1d(6, 8, 5, dilation=2, use_partial_padding=True,
                           use_weight_norm=True),
              MaskedConv1d(6, 8, 1, use_weight_norm=True)):
        x = torch.randn(B, T, 6)
        mask = _mask(mask_kind, torch.float32)
        assert torch.equal(wn_conv.conv(m, x, mask), m(x, mask))


@pytest.mark.parametrize("K,dilation", [(1, 1), (5, 2)])
def test_wgrad_twin_matches_autograd(K, dilation):
    g = torch.Generator().manual_seed(K)
    x = torch.randn((B, T, 6), generator=g, dtype=torch.float64)
    w = torch.randn((5, 6, K), generator=g, dtype=torch.float64,
                    requires_grad=True)
    dy = torch.randn((B, T, 5), generator=g, dtype=torch.float64)
    mask = _mask("holes")
    out = wn_conv.conv_reference(x, w.permute(2, 1, 0), None, mask,
                                 dilation, True, False)
    (out * dy).sum().backward()
    # the output's own mask goes into dy, as the row scales put it there
    got = wn_conv.wgrad_reference(dy * mask[..., None], x, mask, K, dilation)
    torch.testing.assert_close(got.permute(1, 2, 0), w.grad, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("mask_kind,pp,K,dilation,bias", [
    ("ragged", True, 5, 2, True),
    ("length1", True, 5, 1, True),
    ("holes", False, 5, 4, True),
    ("none", True, 5, 8, True),
    ("none", False, 1, 1, True),
    ("ragged", False, 1, 1, False),
])
def test_function_gradcheck(mask_kind, pp, K, dilation, bias, twins):
    """forward, dgrad and wgrad as the function composes them, against
    float64 finite differences."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn((2, 9, 4), generator=g, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((3, 4, K), generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = (torch.randn((3,), generator=g, dtype=torch.float64,
                     requires_grad=True) if bias else None)
    mask = _mask(mask_kind)
    if mask is not None:
        mask = mask[:2, :9].contiguous()

    def f(x, w, b):
        return wn_conv._WNConvF32.apply(x, w, b, mask, dilation, pp, True)

    torch.testing.assert_close(
        f(x, w, b), wn_conv.conv_reference(x, w.permute(2, 1, 0), b, mask,
                                           dilation, True, pp))
    assert torch.autograd.gradcheck(f, (x, w, b), eps=1e-6, atol=1e-7)


def test_wn_through_the_function_agrees(monkeypatch, twins,
                                        one_torch_thread):
    """A WN stack (partial padding, dilations 1 and 2) forward and backward
    with every conv through the autograd function, against its modules."""
    torch.manual_seed(3)
    wn = WN(3, 5, n_layers=2, n_channels=8, kernel_size=5).double()
    with torch.no_grad():
        wn.end.weight.normal_(0.0, 0.1)
        wn.end.bias.normal_(0.0, 0.1)
    z = torch.randn(B, T, 3, dtype=torch.float64, requires_grad=True)
    ctx = torch.randn(B, T, 5, dtype=torch.float64, requires_grad=True)
    mask = _mask("ragged")

    def run():
        wn.zero_grad()
        z.grad = ctx.grad = None
        out = wn(z, ctx, mask)
        (out * torch.linspace(-1, 1, out.numel(), dtype=out.dtype).view(
            out.shape)).sum().backward()
        grads = [p.grad.clone() for p in wn.parameters()]
        return out.detach(), z.grad.clone(), ctx.grad.clone(), grads

    plain = run()
    calls = []

    def routes(module, x):
        calls.append(module)
        return True
    monkeypatch.setattr(wn_conv, "_routes_to_kernel", routes)
    fused = run()
    assert len(calls) == 2 * 2 + 2
    torch.testing.assert_close(fused[0], plain[0], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(fused[1], plain[1], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(fused[2], plain[2], rtol=1e-10, atol=1e-12)
    for a, b in zip(fused[3], plain[3]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_kernel_entry_points_refuse_cpu_tensors():
    x = torch.randn(B, T, 4)
    w = torch.randn(1, 4, 4)
    with pytest.raises(ValueError, match="CUDA"):
        wn_conv.conv_f32(x, w, None, None, 1, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        wn_conv.wgrad_f32(x, x, None, 1, 1)


def test_an_uncentred_module_raises_where_it_routes(monkeypatch):
    """Where a tensor routes to the kernel, a module whose padding is not
    its kernel's centred one raises instead of running elsewhere."""
    monkeypatch.setattr(wn_conv, "_routes_to_kernel", lambda m, x: True)
    m = MaskedConv1d(4, 4, 5, dilation=2, padding=2)
    with pytest.raises(ValueError, match="centred"):
        wn_conv.conv(m, torch.randn(B, T, 4))


@pytest.mark.parametrize("N,C_in,C_out,K", [
    (2048, 1024, 1024, 5), (3584, 1024, 1024, 5), (1280, 1024, 1024, 5),
    (96, 1024, 1024, 5), (400, 1024, 1024, 1), (2048, 1136, 1024, 1),
    (2048, 1024, 158, 1)])
def test_split_plan(N, C_in, C_out, K):
    """Every split of the plan has work; the wgrad's splits cover the rows
    in pieces the kernel describes in shared memory; the flagship's in_i
    (128 tiles, one wave on 132 SMs) is not split, serving's B = 1 shapes
    are."""
    sms = 132
    s = wn_conv.conv_splits(N, C_in, C_out, K, sms)
    stages = K * math.ceil(C_in / wn_conv.STAGE)
    assert 1 <= s <= wn_conv.MAX_SPLITS
    assert (s - 1) * math.ceil(stages / s) < stages
    if (N, C_out, K) == (2048, 1024, 5):
        assert s == 1
    if N <= 400:
        assert s > 1
    splits, rows = wn_conv.wgrad_splits(N, C_in, C_out, K, sms)
    assert rows % wn_conv.STAGE == 0 and rows <= wn_conv.MAX_SPLIT_ROWS
    assert splits * rows >= N > (splits - 1) * rows
    assert wn_conv.wgrad_splits(40000, 1024, 1024, 5, sms)[1] <= 4096
