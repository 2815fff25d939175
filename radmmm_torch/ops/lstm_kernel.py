"""The masked LSTM recurrence: CUDA kernel wrappers (forward and backward),
their plain PyTorch twins and their launch counters.

Counterpart of ``radmmm_tpu/ops/lstm_pallas.py``. Given the precomputed
input projection, every lane ``l`` runs, for t in its walking order,

    gates = x_proj[l, t] + h @ wh[l]        ; i, f, g, o = split(gates)
    c' = f*c + i*g ; h' = o*tanh(c')
    (h, c) <- (h', c') where mask[t] > 0, else kept ; out[l, t] = h' * mask[t]

A lane with ``reverse`` set walks t from T-1 down to 0, which equals
flipping the sequence, scanning and flipping back: leading padding in
reversed order leaves the zero state untouched. A BiLSTM is one call with
two lanes; the three ganged frame predictors are one call with six.

``lstm_recurrence`` is differentiable in ``x_proj`` and ``wh``. When
autograd needs it, the forward also saves the gate activations and the
carried c and h of every step, and the backward runs the reverse-time
recurrence (``csrc/lstm_recurrence_bwd.cu`` on the card,
``lstm_recurrence_backward_reference`` on the CPU); dWh is one batched
matmul over the saved h. Without autograd (serving) nothing extra is
written. ``forward_plan`` and ``backward_plan`` pick each kernel's route
for a shape: a thread-block cluster per lane where the lane's Wh fits
one, else a cooperative grid with a barrier per lane. No barrier spans
two lanes on either route.

In bf16 mode (``ops.conv.get_conv_precision()``, resolved outside the
autograd function, as ``lstm_pallas.py`` resolves its ``precision``)
``h @ Wh`` takes bf16-rounded h and Wh with f32 accumulation, the JAX
package's product at ``Precision.DEFAULT`` on a TPU; the backward's
``dgates @ Wh^T`` and ``dWh = sum h_prev^T dgates`` round their operands
the same way. The gates, c, h and every output stay f32. The kernels'
bf16 variants (``csrc/lstm_recurrence_bf16.cu``) run those products on
the tensor cores: each CTA builds its Wh slice's bf16 A fragments once
for the whole run (two a thread in registers, the rest in shared memory),
and h (or dgates) is rounded to bf16 once, by the CTA that owns it. They
have plans of their own
(``_fwd_smem_bf16``, ``_bwd_smem_bf16``, ``_bf16_tiling``) and count
their launches apart.

Tensors on the CPU run the twins. Tensors on a CUDA device launch
``csrc/lstm_recurrence.cu`` and ``csrc/lstm_recurrence_bwd.cu``, or
``csrc/lstm_recurrence_bf16.cu`` in bf16 (built by ``utils/cuda_build``),
or raise; nothing falls back.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from radmmm_torch.ops.conv import bf16_product, bf16_round, get_conv_precision
from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launched

_plans: dict = {}


def _walk(T: int, reverse: Sequence[bool], device):
    """(lanes, rev flags, (T, L) time index of each lane's step s)."""
    L = len(reverse)
    lanes = torch.arange(L, device=device)
    rev = torch.as_tensor([bool(r) for r in reverse], device=device)
    s = torch.arange(T, device=device)[:, None]
    return lanes, rev, torch.where(rev[None, :], T - 1 - s, s)


def _rounder(bf16: bool):
    return bf16_round if bf16 else (lambda x: x)


def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              wh: torch.Tensor, reverse: Sequence[bool],
                              save: bool = False, bf16: bool = False):
    """Plain PyTorch twin of the forward kernel: a Python loop over time
    of ``torch.bmm`` and elementwise gates; with ``bf16`` the product
    takes h and Wh rounded to bf16 (an f32 product of bf16 values, exact
    but for the order of the sums).

    x_proj (L, T, B, 4H); mask (T, B) or (L, T, B); wh (L, H, 4H);
    reverse: L flags. Returns out (L, T, B, H), zero at masked frames;
    with ``save`` also the gate activations (L, T, B, 4H) and the carried
    c and h after every step (L, T, B, H) each, as the backward needs."""
    L, T, B, G = x_proj.shape
    H = G // 4
    m = mask.expand(L, T, B) if mask.dim() == 2 else mask
    lanes, _, order = _walk(T, reverse, x_proj.device)
    r = _rounder(bf16)
    wh_r = r(wh)
    h = x_proj.new_zeros((L, B, H))
    c = x_proj.new_zeros((L, B, H))
    out = x_proj.new_empty((L, T, B, H))
    if save:
        act, cs, hs = (x_proj.new_empty((L, T, B, G)),
                       x_proj.new_empty((L, T, B, H)),
                       x_proj.new_empty((L, T, B, H)))
    for s in range(T):
        t = order[s]
        gates = x_proj[lanes, t] + torch.bmm(r(h), wh_r)
        i, f, g, o = gates.split(H, dim=-1)
        i, f, g, o = (torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g),
                      torch.sigmoid(o))
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        mt = m[lanes, t][..., None]
        h = torch.where(mt > 0, h_new, h)
        c = torch.where(mt > 0, c_new, c)
        out[lanes, t] = h_new * mt
        if save:
            act[lanes, t] = torch.cat([i, f, g, o], dim=-1)
            cs[lanes, t] = c
            hs[lanes, t] = h
    return (out, act, cs, hs) if save else out


def lstm_recurrence_backward_reference(dout: torch.Tensor, act: torch.Tensor,
                                       cs: torch.Tensor, mask: torch.Tensor,
                                       wh: torch.Tensor,
                                       reverse: Sequence[bool],
                                       bf16: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the backward kernel: reverse-time BPTT over
    the saved gate activations ``act`` and carried cell states ``cs``.
    Returns d x_proj (L, T, B, 4H): the gate pre-activations' gradient,
    zero at masked frames, where dh and dc pass through unchanged. With
    ``bf16`` the product dgates @ Wh^T takes both rounded to bf16."""
    L, T, B, H = dout.shape
    m = mask.expand(L, T, B) if mask.dim() == 2 else mask
    lanes, _, order = _walk(T, reverse, dout.device)
    r = _rounder(bf16)
    wh_t = r(wh).transpose(1, 2)
    dxp = dout.new_zeros((L, T, B, 4 * H))
    dh_pass = dout.new_zeros((L, B, H))
    dc_pass = dout.new_zeros((L, B, H))
    rec = dout.new_zeros((L, B, H))
    for s in range(T - 1, -1, -1):
        t = order[s]
        c_prev = (cs[lanes, order[s - 1]] if s > 0
                  else torch.zeros_like(dh_pass))
        i, f, g, o = act[lanes, t].split(H, dim=-1)
        tc = torch.tanh(cs[lanes, t])
        mt = m[lanes, t][..., None]
        keep = mt > 0
        dh = dh_pass + rec
        dhn = dh + dout[lanes, t] * mt
        dcn = dc_pass + dhn * o * (1 - tc * tc)
        dgates = torch.cat([dcn * g * i * (1 - i),
                            dcn * c_prev * f * (1 - f),
                            dcn * i * (1 - g * g),
                            dhn * tc * o * (1 - o)], dim=-1)
        dgates = torch.where(keep, dgates, torch.zeros_like(dgates))
        dh_pass = torch.where(keep, torch.zeros_like(dh), dh)
        dc_pass = torch.where(keep, dcn * f, dc_pass)
        rec = torch.bmm(r(dgates), wh_t)
        dxp[lanes, t] = dgates
    return dxp


def recurrent_weight_grad(hs: torch.Tensor, dxp: torch.Tensor,
                          reverse: Sequence[bool],
                          bf16: bool = False) -> torch.Tensor:
    """dWh (L, H, 4H) = sum over steps of h_prev^T dgates: one batched
    product over the carried h entering each step and d x_proj, with
    bf16-rounded operands and f32 accumulation under ``bf16``."""
    L, T, B, G = dxp.shape
    h_prev = _h_before(hs, reverse).view(L, T * B, G // 4).transpose(1, 2)
    dg = dxp.view(L, T * B, G)
    return bf16_product(h_prev, dg) if bf16 else torch.bmm(h_prev, dg)


def _h_before(hs: torch.Tensor, reverse: Sequence[bool]) -> torch.Tensor:
    """The carried h entering each step (zero at each lane's first)."""
    prev = torch.zeros_like(hs)
    for l, r in enumerate(reverse):
        if r:
            prev[l, :-1] = hs[l, 1:]
        else:
            prev[l, 1:] = hs[l, :-1]
    return prev


def _check(x_proj, mask, wh, reverse):
    L, T, B, G = x_proj.shape
    H = G // 4
    if (G != 4 * H or wh.shape != (L, H, G) or len(reverse) != L
            or mask.shape not in ((T, B), (L, T, B))):
        raise ValueError(
            f"lstm_recurrence: x_proj {tuple(x_proj.shape)}, mask "
            f"{tuple(mask.shape)}, wh {tuple(wh.shape)}, {len(reverse)} "
            "reverse flags do not describe L lanes of (T, B, 4H)")
    for name, t in (("x_proj", x_proj), ("mask", mask), ("wh", wh)):
        if t.dtype != torch.float32:
            raise TypeError(f"lstm_recurrence: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"lstm_recurrence: {name} is on {t.device}, "
                             f"x_proj on {x_proj.device}")
        if not t.is_contiguous():
            raise ValueError(f"lstm_recurrence: {name} must be contiguous")
    if x_proj.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"lstm_recurrence: no kernel for device {x_proj.device}")
    if x_proj.device.type == "cuda" and L > 64:
        raise ValueError("lstm_recurrence: at most 64 lanes per launch")


class _LSTMRecurrence(torch.autograd.Function):
    """The recurrence with its backward: the kernels on the card, the
    twins on the CPU."""

    @staticmethod
    def forward(ctx, x_proj, mask, wh, reverse, bf16):
        if x_proj.device.type == "cpu":
            out, act, cs, hs = lstm_recurrence_reference(
                x_proj, mask, wh, reverse, save=True, bf16=bf16)
        else:
            out, act, cs, hs = _forward_kernel(x_proj, mask, wh, reverse,
                                               save=True, bf16=bf16)
        ctx.reverse, ctx.bf16 = tuple(reverse), bf16
        ctx.save_for_backward(mask, wh, act, cs, hs)
        return out

    @staticmethod
    def backward(ctx, dout):
        mask, wh, act, cs, hs = ctx.saved_tensors
        dout = dout.contiguous()
        if dout.device.type == "cpu":
            dxp = lstm_recurrence_backward_reference(
                dout, act, cs, mask, wh, ctx.reverse, bf16=ctx.bf16)
        else:
            dxp = _backward_kernel(dout, act, cs, mask, wh, ctx.reverse,
                                   bf16=ctx.bf16)
        dwh = recurrent_weight_grad(hs, dxp, ctx.reverse, ctx.bf16)
        return dxp, None, dwh, None, None


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    wh: torch.Tensor, reverse: Sequence[bool],
                    bf16: Optional[bool] = None) -> torch.Tensor:
    """The masked multi-lane LSTM recurrence (see the module docstring).
    ``bf16`` None takes the process-wide conv precision.

    CPU tensors run the plain twins; CUDA tensors launch the kernels."""
    _check(x_proj, mask, wh, reverse)
    if bf16 is None:
        bf16 = get_conv_precision() == "bf16"
    if torch.is_grad_enabled() and (x_proj.requires_grad
                                    or wh.requires_grad):
        return _LSTMRecurrence.apply(x_proj, mask, wh, list(reverse), bf16)
    if x_proj.device.type == "cpu":
        return lstm_recurrence_reference(x_proj, mask, wh, reverse,
                                         bf16=bf16)
    return _forward_kernel(x_proj, mask, wh, reverse, save=False, bf16=bf16)


def _forward_kernel(x_proj, mask, wh, reverse, save: bool, plan=None,
                    bf16: bool = False):
    """The forward kernel's launch (its bf16 variant under ``bf16``), by
    ``card_forward_plan`` unless a plan is given (``scripts/sweep_lstm.py``
    times the alternatives)."""
    L, T, B, G = x_proj.shape
    H = G // 4
    dev = x_proj.device
    out = torch.empty((L, T, B, H), dtype=torch.float32, device=dev)
    saved = ((torch.empty((L, T, B, G), dtype=torch.float32, device=dev),
              torch.empty((L, T, B, H), dtype=torch.float32, device=dev),
              torch.empty((L, T, B, H), dtype=torch.float32, device=dev))
             if save else None)
    if T == 0 or B == 0:
        return (out, *saved) if save else out
    library, name = _kernel("fwd", bf16)
    lib = library()
    with torch.cuda.device(dev):
        plan = plan or card_forward_plan(L, B, H, bf16)
        grid = plan.route == "grid"
        hbuf = arrived = None
        if grid:
            # the h exchange through L2 (its padding rows stay zero; bf16 in
            # N tiles of 8 rows for the bf16 kernel) and the lanes' barrier
            # counters, referenced here until the launch is queued
            hbuf = (torch.zeros((2, L, -(-B // 8), H, 8), dtype=torch.bfloat16,
                                device=dev) if bf16 else
                    torch.zeros((2, L, H, _rows(B)), dtype=torch.float32,
                                device=dev))
            arrived = torch.zeros(L, dtype=torch.int32, device=dev)
        ptrs = [t.data_ptr() for t in saved] if save else [None] * 3
        err = getattr(lib, f"{name}_launch")(
            x_proj.data_ptr(), mask.data_ptr(), wh.data_ptr(),
            out.data_ptr(), *ptrs, hbuf.data_ptr() if grid else None,
            arrived.data_ptr() if grid else None, L, T, B, H,
            T * B if mask.dim() == 3 else 0, _bits(reverse),
            int(not grid), plan.n_cta, plan.hb, plan.ks,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, name)
    launched("lstm_recurrence_bf16" if bf16 else "lstm_recurrence")
    return (out, *saved) if save else out


def _backward_kernel(dout, act, cs, mask, wh, reverse, plan=None,
                     bf16: bool = False):
    """The backward kernel's launch (its bf16 variant under ``bf16``), by
    ``card_backward_plan`` unless a plan is given
    (``scripts/sweep_lstm.py`` times the alternatives)."""
    L, T, B, H = dout.shape
    dev = dout.device
    dxp = torch.empty((L, T, B, 4 * H), dtype=torch.float32, device=dev)
    if T == 0 or B == 0:
        return dxp
    library, name = _kernel("bwd", bf16)
    lib = library()
    with torch.cuda.device(dev):
        plan = plan or card_backward_plan(L, B, H, bf16)
        grid = plan.route == "grid"
        part = arrived = None
        if grid:
            # the exchange of partials through L2 (batch rows padded to 4,
            # or to N tiles of 8 for the bf16 kernel) and the lanes' barrier
            # counters, referenced here until the launch is queued
            rows = -(-B // 8) * 8 if bf16 else -(-B // 4) * 4
            part = torch.empty((L, 2, plan.n_cta, H, rows),
                               dtype=torch.float32, device=dev)
            arrived = torch.zeros(L, dtype=torch.int32, device=dev)
        err = getattr(lib, f"{name}_launch")(
            dout.data_ptr(), act.data_ptr(), cs.data_ptr(), mask.data_ptr(),
            wh.data_ptr(), dxp.data_ptr(), part.data_ptr() if grid else None,
            arrived.data_ptr() if grid else None, L, T, B, H,
            T * B if mask.dim() == 3 else 0, _bits(reverse),
            int(not grid), plan.n_cta, plan.hb, plan.ks,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, name)
    launched("lstm_recurrence_bwd_bf16" if bf16 else "lstm_recurrence_bwd")
    return dxp


@dataclasses.dataclass(frozen=True)
class CardLimits:
    """What a plan needs to know of a card."""
    sms: int
    smem_per_block: int        # dynamic shared memory a block may opt into
    smem_per_sm: int
    regs_per_thread: int       # the grid route's kernel as compiled; 0: no
    max_cluster: int           # limit known. 16: Hopper's non-portable
                               # cluster size (8 is the portable one)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the forward or the backward kernel runs one (L, B, H)
    recurrence.

    route: "cluster", one thread-block cluster of n_cta CTAs per lane, the
    exchange through distributed shared memory; or "grid", a cooperative
    grid of L * n_cta CTAs, the exchange through L2 and a barrier per lane.
    hb: hidden units per CTA; ks: chunks each CTA's product is split into;
    smem: dynamic shared memory bytes per CTA."""
    route: str
    n_cta: int
    hb: int
    ks: int
    smem: int


_FWD_THREADS = 256          # kThreads in lstm_recurrence.cu
_BWD_THREADS = 384          # kThreads in lstm_recurrence_bwd.cu
_RESERVED_SMEM = 1024       # per block, kept by the CUDA runtime on sm_90
_THREADS_PER_SM, _REGS_PER_SM = 2048, 65536     # sm_80 and later
# hidden units per CTA on the grid route, in order of preference
_GRID_WIDTHS = (8, 16, 4, 32, 2, 1)
# chunks of the backward's partial product (ks): the fastest at every
# training shape in scripts/sweep_lstm.py on an H100
_CLUSTER_CHUNKS, _GRID_CHUNKS = 2, 1
# the forward splits a CTA's H reduction into this many chunks, as far as
# its threads allow (two columns a thread): 8 was the fastest or within 1%
# of it at every serving and training shape in scripts/sweep_lstm.py on an
# H100
_FWD_CHUNKS = 8
# the bf16 kernels (lstm_recurrence_bf16.cu): kThreads, kRegSlots (A
# fragments a thread keeps in registers) and kMaxM (M tiles a warp takes at
# once)
_BF16_THREADS = 384
_BF16_WARPS = _BF16_THREADS // 32
_BF16_REG_SLOTS, _BF16_MAX_M = 2, 3
# the bf16 forward's warps split its H reduction 4 ways (ks): the fastest
# or within 1% of it at every serving and training shape in
# scripts/sweep_lstm.py --bf16 on an H100
_BF16_FWD_SPLIT = 4


def _up4(n: int) -> int:
    return -(-n // 4) * 4


def _rows(B: int) -> int:
    """Batch rows as the forward's product tiles them: pad_rows in the .cu
    file."""
    return 4 if B <= 4 else -(-B // 8) * 8


def _fwd_smem(B: int, H: int, hb: int, ks: int, n_cta: int,
              cluster: bool) -> int:
    """Dynamic shared memory of one forward CTA: make_layout in
    lstm_recurrence.cu."""
    Bp, nc, kc = _rows(B), 4 * hb, -(-H // ks)
    hp = kc * ks
    hr = max(hp, n_cta * hb)
    h = _up4(hp * nc)
    part = _up4(h + (2 if cluster else 1) * hr * Bp)
    return 4 * (part + ks * Bp * nc)


def _fwd_chunks(hb: int) -> int:
    """The forward's ks on either route: _FWD_CHUNKS, or fewer where the
    threads run out (one a (column pair, chunk)); 0 where hb leaves no
    thread for it."""
    return min(_FWD_THREADS // (2 * hb), _FWD_CHUNKS)


def _bwd_smem(B: int, H: int, hb: int, ks: int, n_cta: int,
              cluster: bool) -> int:
    """Dynamic shared memory of one backward CTA: make_layout in
    lstm_recurrence_bwd.cu."""
    Bp, kc = -(-B // 4) * 4, -(-4 * hb // ks)
    gp = kc * ks
    dg = _up4(gp * H)
    part = _up4(dg + gp * Bp)
    rx = _up4(part + (ks * H * Bp if ks > 1 else 0))
    return 4 * (rx + (2 * n_cta * hb * Bp if cluster else _BWD_THREADS))


def _bf16_tiling(M: int, K: int, wk: int) -> tuple:
    """make_tiling in lstm_recurrence_bf16.cu for a CTA's product of M x K
    tiles of 16 x 16 over 12 // wk x wk warps: (mma a warp issues for an N
    tile, M tiles it takes at once, A fragments it keeps in shared memory:
    those past the registers)."""
    wm = _BF16_WARPS // wk
    mpw, kpw = -(-M // wm), -(-K // wk)
    max_m = min(mpw, _BF16_MAX_M)
    npass = -(-mpw // max_m)
    slots = (npass * kpw - min(kpw, _BF16_REG_SLOTS // max_m)) * max_m
    return mpw * kpw, max_m, slots


def _fwd_smem_bf16(B: int, H: int, hb: int, ks: int, n_cta: int,
                   cluster: bool) -> int:
    """Dynamic shared memory of one bf16 forward CTA: fwd_layout in
    lstm_recurrence_bf16.cu (A fragments past the registers, h in bf16
    rows of 8, the warps' partial gate tiles, 4 floats past each row)."""
    M, K, NT = -(-4 * hb // 16), -(-H // 16), -(-B // 8)
    hr = max(16 * K, n_cta * hb)
    return (_BF16_WARPS * _bf16_tiling(M, K, ks)[2] * 512
            + (2 if cluster else 1) * NT * hr * 16
            + ks * NT * 8 * (16 * M + 4) * 4)


def _bwd_smem_bf16(B: int, H: int, hb: int, ks: int, n_cta: int,
                   cluster: bool) -> int:
    """Dynamic shared memory of one bf16 backward CTA: bwd_layout in
    lstm_recurrence_bf16.cu (A fragments past the registers, dgates in bf16
    rows of 8, the partials received or the gather's sums)."""
    M, K, NT = -(-H // 16), -(-4 * hb // 16), -(-B // 8)
    return (_BF16_WARPS * _bf16_tiling(M, K, 1)[2] * 512 + NT * K * 256
            + 4 * (2 * n_cta * hb * NT * 8 if cluster else _BF16_THREADS))


def _route_plan(L: int, B: int, H: int, limits: CardLimits, name: str,
                threads: int, smem_fn, cluster_ks, grid_ks,
                route: Optional[str] = None) -> Plan:
    """The route and sizes of one kernel for L lanes of (B, H): the kernel
    (``name`` in errors) runs ``threads`` a CTA, takes ``smem_fn(B, H, hb,
    ks, n_cta, cluster)`` bytes of dynamic shared memory, and splits its
    product into ``cluster_ks(hb)`` or ``grid_ks(hb)`` chunks.

    A lane runs as one cluster when its Wh fits the shared memory of at
    most ``limits.max_cluster`` CTAs (each keeps 4 hb columns of it, with
    hb = ceil(H / max_cluster): the most CTAs, since the per-step product
    sets the pace); otherwise as a cooperative grid, with the first slice
    width in _GRID_WIDTHS whose L * ceil(H / hb) CTAs are all resident at
    once. ``route`` "cluster" or "grid" tries that route alone. Each CTA
    runs one cell per thread, so B * hb is at most the kernel's threads.
    Raises when no route fits."""
    if limits.max_cluster >= 1 and route in (None, "cluster"):
        hb = -(-H // limits.max_cluster)
        n_cta = -(-H // hb)
        ks = cluster_ks(hb)
        if B * hb <= threads and ks >= 1:
            smem = smem_fn(B, H, hb, ks, n_cta, True)
            if smem <= limits.smem_per_block:
                return Plan("cluster", n_cta, hb, ks, smem)
    for hb in _GRID_WIDTHS if route in (None, "grid") else ():
        ks = grid_ks(hb)
        if B * hb > threads or ks < 1:
            continue
        n_cta = -(-H // hb)
        smem = smem_fn(B, H, hb, ks, n_cta, False)
        if smem > limits.smem_per_block:
            continue
        per_sm = min(_THREADS_PER_SM // threads,
                     limits.smem_per_sm // (smem + _RESERVED_SMEM))
        if limits.regs_per_thread:
            per_sm = min(per_sm, _REGS_PER_SM // (
                threads * -(-limits.regs_per_thread // 8) * 8))
        if L * n_cta <= per_sm * limits.sms:
            return Plan("grid", n_cta, hb, ks, smem)
    raise RuntimeError(
        f"lstm_recurrence ({name}): no {route + ' ' if route else ''}route "
        f"fits the L={L}, B={B}, H={H} recurrence on a card with "
        f"{limits.sms} SMs and "
        f"{limits.smem_per_block} bytes of shared memory per block")


def forward_plan(L: int, B: int, H: int, limits: CardLimits,
                 bf16: bool = False, route: Optional[str] = None) -> Plan:
    """The forward kernel's route and sizes for L lanes of (B, H), or its
    bf16 variant's under ``bf16``: see ``_route_plan``. The f32 CTA splits
    the H reduction into _FWD_CHUNKS chunks where its threads allow; the
    bf16 CTA's warps split it _BF16_FWD_SPLIT ways."""
    if bf16:
        return _route_plan(L, B, H, limits, "fwd bf16", _BF16_THREADS,
                           _fwd_smem_bf16, lambda hb: _BF16_FWD_SPLIT,
                           lambda hb: _BF16_FWD_SPLIT, route)
    return _route_plan(L, B, H, limits, "fwd", _FWD_THREADS, _fwd_smem,
                       _fwd_chunks, _fwd_chunks, route)


def backward_plan(L: int, B: int, H: int, limits: CardLimits,
                  bf16: bool = False, route: Optional[str] = None) -> Plan:
    """The backward kernel's route and sizes for L lanes of (B, H), or its
    bf16 variant's under ``bf16``: see ``_route_plan``. The f32 partial
    product takes _CLUSTER_CHUNKS chunks on a cluster, _GRID_CHUNKS on the
    grid; the bf16 one one (its warps split the units)."""
    if bf16:
        return _route_plan(L, B, H, limits, "bwd bf16", _BF16_THREADS,
                           _bwd_smem_bf16, lambda hb: 1, lambda hb: 1,
                           route)
    return _route_plan(L, B, H, limits, "bwd", _BWD_THREADS, _bwd_smem,
                       lambda hb: _CLUSTER_CHUNKS, lambda hb: _GRID_CHUNKS,
                       route)


def card_limits(library, name: str) -> CardLimits:
    """The current CUDA device's limits for the plan of the kernel ``name``
    in ``library()``, read from the CUDA driver once per device."""
    dev = torch.cuda.current_device()
    key = ("limits", name, dev)
    if key not in _plans:
        lib = library()
        vals = [ctypes.c_int(0) for _ in range(4)]
        cuda_build.check(lib, getattr(lib, f"{name}_limits")(
            *[ctypes.byref(v) for v in vals]), name)
        sms, smem_block, smem_sm, regs = (v.value for v in vals)
        hopper = torch.cuda.get_device_capability(dev)[0] >= 9
        _plans[key] = CardLimits(sms, smem_block, smem_sm, regs,
                                 max_cluster=16 if hopper else 8)
    return _plans[key]


def _card_plan(plan_fn, direction: str, L: int, B: int, H: int,
               bf16: bool) -> Plan:
    """``plan_fn``'s plan of the ``direction`` kernel (its bf16 variant
    under ``bf16``) for the current CUDA device, with a cluster plan only
    where the CUDA driver says such a cluster fits (else the next smaller
    one). Cached per device, variant and shape."""
    library, name = _kernel(direction, bf16)
    key = (name, torch.cuda.current_device(), L, B, H)
    if key not in _plans:
        lib = library()
        limits = card_limits(library, name)
        while True:
            plan = plan_fn(L, B, H, limits, bf16)
            if plan.route == "grid":
                break
            fit = ctypes.c_int(0)
            cuda_build.check(lib, getattr(lib, f"{name}_clusters")(
                B, H, plan.hb, plan.ks, plan.n_cta, ctypes.byref(fit)), name)
            if fit.value >= 1:
                break
            limits = dataclasses.replace(limits, max_cluster=plan.n_cta - 1)
        _plans[key] = plan
    return _plans[key]


def card_forward_plan(L: int, B: int, H: int, bf16: bool = False) -> Plan:
    """forward_plan for the current CUDA device (see ``_card_plan``)."""
    return _card_plan(forward_plan, "fwd", L, B, H, bf16)


def card_backward_plan(L: int, B: int, H: int, bf16: bool = False) -> Plan:
    """backward_plan for the current CUDA device (see ``_card_plan``)."""
    return _card_plan(backward_plan, "bwd", L, B, H, bf16)


def _bits(reverse) -> int:
    return sum(1 << l for l, r in enumerate(reverse) if r)


def _declare(lib, name: str, n_ptrs: int):
    """argtypes of a kernel's launch, limits and cluster check."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [vp] * n_ptrs + [ci, ci, ci, ci, ctypes.c_longlong,
                                       ctypes.c_ulonglong, ci, ci, ci, ci,
                                       vp]
    launch.restype = ci
    limits = getattr(lib, f"{name}_limits")
    limits.argtypes = [ctypes.POINTER(ci)] * 4
    limits.restype = ci
    clusters = getattr(lib, f"{name}_clusters")
    clusters.argtypes = [ci] * 5 + [ctypes.POINTER(ci)]
    clusters.restype = ci


def _library():
    return cuda_build.load("lstm_recurrence",
                           lambda lib: _declare(lib, "lstm_recurrence", 9))


def _bwd_library():
    return cuda_build.load("lstm_recurrence_bwd",
                           lambda lib: _declare(lib, "lstm_recurrence_bwd", 8))


def _bf16_library():
    def declare(lib):
        _declare(lib, "lstm_bf16_fwd", 9)
        _declare(lib, "lstm_bf16_bwd", 8)
    return cuda_build.load("lstm_recurrence_bf16", declare)


def _kernel(direction: str, bf16: bool) -> tuple:
    """(library loader, C name) of the ``direction`` ("fwd" or "bwd")
    kernel, its bf16 variant under ``bf16``."""
    if bf16:
        return _bf16_library, f"lstm_bf16_{direction}"
    return ((_library, "lstm_recurrence") if direction == "fwd"
            else (_bwd_library, "lstm_recurrence_bwd"))
