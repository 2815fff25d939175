"""The port's CUDA kernels on the card, against their plain twins.

A CUDA kernel has no CPU mode, so these tests carry the ``cuda`` marker
and skip without a card. The file imports torch and the port only, so it
runs where JAX is not installed:

    python -m pytest tests/test_torch_kernel_cuda.py -m cuda

Tolerances: the LSTM kernels 1e-5 (f32 on both sides, TF32 off, the kernel
sums its products in another order than torch.bmm); the CTC DPs 1e-5
relative to the magnitude (alphas reach -2,500 at 512 frames, where one
f32 ulp is 2.4e-4; both sides do the same ops in the same order); MAS and
pYIN's Viterbi bit for bit (adds and compares of the same f32 values); the
fused conv + softplus 1e-4 (the same exact bf16 products, up to 5,120 per
output, summed in f32 in another order); the WN convolutions (K7) 1e-5 of
the largest magnitude (f32 products, up to 5,120 per output, summed in
another order); the LSTM kernels' bf16 variants BF16_ATOL."""
import copy

import numpy as np
import pytest
import torch

from radmmm_torch.data import pitch
from radmmm_torch.losses import ctc_kernel
from radmmm_torch.losses.ctc import _ctc_setup
from radmmm_torch.ops import alignment, lstm_kernel, wn_conv, wn_kernel
from radmmm_torch.ops.lstm import MaskedLSTM
from radmmm_torch.ops.lstm_kernel import (_backward_kernel,
                                          _forward_kernel,
                                          lstm_recurrence,
                                          lstm_recurrence_backward_reference,
                                          lstm_recurrence_reference)
from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread for the module's tests, as in every port test
    file (tests/test_torch_threads.py says why). Defined here, not
    imported from ``tests``: where this file runs, an installed package
    of that name may shadow the repository's tests directory."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LSTM_KERNELS = ("lstm_recurrence", "lstm_recurrence_bwd",
                "lstm_recurrence_bf16", "lstm_recurrence_bwd_bf16")
# the kernels of a binarized training step
STEP_KERNELS = ("lstm_recurrence", "lstm_recurrence_bwd", "ctc_alpha",
                "ctc_beta", "mas_width1", "wn_conv_fwd", "wn_conv_dgrad",
                "wn_conv_wgrad")


def _counts(*names) -> tuple:
    """The launch registry's counts of ``names``."""
    return tuple(launch_counts[n] for n in names)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


def _lstm_inputs(dev, L, H, T, B, seed=0, non_prefix=False):
    g = torch.Generator(device=dev).manual_seed(seed)
    xp = torch.randn((L, T, B, 4 * H), generator=g, device=dev)
    wh = (torch.rand((L, H, 4 * H), generator=g, device=dev) * 2 - 1) \
        / H ** 0.5
    lens = torch.tensor([T - i * T // (B + 1) for i in range(B)])
    mask = (torch.arange(T)[:, None] < lens[None, :]).float()
    if non_prefix:
        mask[T // 3, 0] = 0.0
    rev = [bool(l % 2) for l in range(L)]
    return xp, mask.to(dev), wh, rev


@pytest.mark.parametrize("L,H,T,B,save", [
    (2, 260, 96, 8, False), (6, 128, 200, 1, False), (2, 528, 64, 3, False),
    (1, 20, 7, 2, False),
    (6, 128, 800, 1, False),      # the serving frame bucket
    (12, 128, 64, 8, False),      # more lanes than clusters fit at once
    (2, 260, 96, 8, True), (2, 128, 96, 8, True), (6, 128, 512, 8, True),
    (2, 528, 256, 8, True),       # the training step's four
    (1, 20, 31, 8, True), (2, 528, 20, 1, True)])
def test_kernel_matches_twin(cuda, L, H, T, B, save):
    """The forward kernel against its twin, with a mask that is not a
    prefix, for B > 1 one item with every frame masked, and every odd lane
    reversed; with ``save`` the gate activations and the carried c and h
    too. A lane per cluster for H <= 260, the cooperative grid with a
    barrier per lane for H = 528."""
    xp, mask, wh, rev = _lstm_inputs(cuda, L, H, T, B, non_prefix=True)
    if B > 1:
        mask[:, -1] = 0.0
    before = launch_counts["lstm_recurrence"]
    if save:
        got = _forward_kernel(xp, mask, wh, rev, save=True)
    else:
        got = (lstm_recurrence(xp, mask, wh, rev),)
    assert launch_counts["lstm_recurrence"] == before + 1
    assert lstm_kernel.card_forward_plan(L, B, H).route == (
        "grid" if H > 260 else "cluster")
    want = lstm_recurrence_reference(xp, mask, wh, rev, save=save)
    for g, w in zip(got, want if save else (want,)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
    if B > 1:
        assert not got[0][:, :, -1].any()


def test_masked_lstm_on_the_card_matches_the_cpu(cuda):
    torch.manual_seed(0)
    lstm = MaskedLSTM(12, 9, spectral_norm=True)
    x = torch.randn(3, 17, 12)
    mask = torch.arange(17)[None, :] < torch.tensor([[17], [5], [0]])
    with torch.inference_mode():
        want = lstm(x, mask)
        before = launch_counts["lstm_recurrence"]
        got = lstm.to(cuda)(x.to(cuda), mask.to(cuda))
    assert launch_counts["lstm_recurrence"] == before + 1
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("L,H,T,B", [(2, 260, 96, 8), (6, 128, 512, 8),
                                     (2, 528, 256, 8), (2, 20, 9, 3),
                                     (1, 20, 31, 8), (6, 128, 40, 1),
                                     (1, 260, 50, 3), (2, 260, 17, 1),
                                     (1, 528, 33, 3), (2, 528, 20, 1),
                                     (6, 20, 64, 8)])
def test_backward_kernel_matches_twin(cuda, L, H, T, B):
    """The saved forward states of the kernel, then the backward kernel
    and the BPTT twin on them, with a mask that is not a prefix and, for
    B > 1, one item with every frame masked; a lane per cluster for
    H <= 260, the cooperative grid for H = 528. The reduce-scatter sums
    the partial dh in another order than torch.bmm: 1e-5 relative, with
    a 1e-5 floor."""
    xp, mask, wh, rev = _lstm_inputs(cuda, L, H, T, B, non_prefix=True)
    if B > 1:
        mask[:, -1] = 0.0
    out, act, cs, hs = lstm_recurrence_reference(xp, mask, wh, rev,
                                                 save=True)
    dout = torch.randn_like(out)
    before = launch_counts["lstm_recurrence_bwd"]
    got = _backward_kernel(dout, act, cs, mask, wh, rev)
    assert launch_counts["lstm_recurrence_bwd"] == before + 1
    assert lstm_kernel.card_backward_plan(L, B, H).route == (
        "grid" if H > 260 else "cluster")
    want = lstm_recurrence_backward_reference(dout, act, cs, mask, wh, rev)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    if B > 1:
        assert not got[:, :, -1].any()


def test_function_returns_gradients_on_the_card(cuda):
    """The recurrence under autograd on the card: a grad_fn, both kernels
    launched once, gradients equal to autograd through the plain twin, and
    a central finite difference along a random direction."""
    xp, mask, wh, rev = _lstm_inputs(cuda, 2, 12, 9, 3, non_prefix=True)
    xp.requires_grad_()
    wh.requires_grad_()
    f0, b0 = _counts("lstm_recurrence", "lstm_recurrence_bwd")
    out = lstm_recurrence(xp, mask, wh, rev)
    assert out.grad_fn is not None
    w = torch.randn_like(out)
    gx, gw = torch.autograd.grad((out * w).sum(), (xp, wh))
    assert _counts("lstm_recurrence", "lstm_recurrence_bwd") == (f0 + 1,
                                                                 b0 + 1)
    want = torch.autograd.grad(
        (lstm_recurrence_reference(xp, mask, wh, rev) * w).sum(), (xp, wh))
    torch.testing.assert_close(gx, want[0], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gw, want[1], atol=1e-5, rtol=1e-5)
    # finite difference in f32: eps 1e-2, so tolerance 1e-2 relative
    dx, dw = torch.randn_like(xp), torch.randn_like(wh)
    eps = 1e-2
    with torch.no_grad():
        f = lambda s: (lstm_recurrence(xp + s * dx, mask, wh + s * dw, rev)
                       * w).sum()
        fd = (f(eps) - f(-eps)) / (2 * eps)
    an = (gx * dx).sum() + (gw * dw).sum()
    torch.testing.assert_close(fd, an, rtol=1e-2, atol=1e-3)


# the bf16 variants against their bf16 twins: the same bf16-rounded
# operands and f32 sums in another order, so the f32 h each side rounds can
# land on either side of a bf16 rounding boundary and move one operand by
# 2^-8 of itself: 1e-3 (forward absolute; backward relative with a 1e-3
# floor)
BF16_ATOL = 1e-3


def _bf16_plan(direction, L, B, H, route):
    """The bf16 kernel's plan on this card's limits, on ``route`` alone
    (None: the route the plan picks)."""
    library, name = lstm_kernel._kernel(direction, True)
    plan_fn = {"fwd": lstm_kernel.forward_plan,
               "bwd": lstm_kernel.backward_plan}[direction]
    return plan_fn(L, B, H, lstm_kernel.card_limits(library, name),
                   bf16=True, route=route)


def _bf16_case(dev, L, H, T, B, dead_lane):
    """Inputs with a mask that is not a prefix and, for B > 1, one item
    with every frame masked; with ``dead_lane`` a mask a lane, lane 0's
    all zero."""
    xp, mask, wh, rev = _lstm_inputs(dev, L, H, T, B, non_prefix=True)
    if B > 1:
        mask[:, -1] = 0.0
    if dead_lane:
        mask = mask.expand(L, T, B).clone()
        mask[0] = 0.0
    return xp, mask, wh, rev


# (L, H, T, B, route, dead lane): the serving and training shapes by their
# plans and the flow context's lane on both routes, batches that pad the
# product's N tile of 8 (1, 3, 5) or take two (11), H that is no multiple
# of 16 (260, 100, 20), one step, a lane whose every frame is masked, and
# an H past the model's
BF16_CASES = [
    (2, 260, 96, 1, None, False), (2, 128, 96, 1, None, False),
    (6, 128, 800, 1, None, False), (2, 528, 400, 1, None, False),
    (2, 528, 400, 1, "cluster", False), (2, 528, 400, 1, "grid", False),
    (2, 260, 96, 8, None, False), (2, 128, 96, 8, None, False),
    (6, 128, 512, 8, None, False), (2, 528, 256, 8, None, False),
    (2, 528, 256, 8, "cluster", False), (2, 528, 256, 8, "grid", False),
    (2, 260, 40, 3, None, False), (1, 100, 33, 5, None, False),
    (2, 20, 17, 5, "grid", False), (2, 260, 30, 3, "grid", False),
    (1, 528, 33, 3, None, False),
    (2, 260, 1, 8, None, False), (2, 528, 1, 1, None, False),
    (2, 128, 50, 11, None, False), (2, 528, 30, 11, None, False),
    (3, 260, 48, 8, None, True),
    (1, 600, 20, 3, None, False)]   # the backward's warps: two passes of
                                    # their M tiles (38 over 12 warps)


@pytest.mark.parametrize("L,H,T,B,route,dead_lane", BF16_CASES)
def test_bf16_kernel_matches_twin(cuda, L, H, T, B, route, dead_lane):
    """The forward kernel's bf16 variant against the bf16 twin, serving
    (no saved states) at B = 1 and training (gates, c and h saved)
    otherwise, by its plan (a cluster a lane at B <= 8; at H 528 and B 11
    the slices take the grid) or on the route given; only the bf16 counter
    moves."""
    xp, mask, wh, rev = _bf16_case(cuda, L, H, T, B, dead_lane)
    save = B > 1
    plan = _bf16_plan("fwd", L, B, H, route) if route else None
    before = _counts("lstm_recurrence", "lstm_recurrence_bf16")
    if save or plan:
        got = _forward_kernel(xp, mask, wh, rev, save=save, plan=plan,
                              bf16=True)
        got = got if save else (got,)
    else:
        got = (lstm_recurrence(xp, mask, wh, rev, bf16=True),)
    assert _counts("lstm_recurrence", "lstm_recurrence_bf16") == (
        before[0], before[1] + 1)
    if B <= 8 and H <= 528:     # the model's shapes: a cluster a lane
        assert lstm_kernel.card_forward_plan(L, B, H, bf16=True).route == \
            "cluster"
    want = lstm_recurrence_reference(xp, mask, wh, rev, save=save,
                                     bf16=True)
    for g, w in zip(got, want if save else (want,)):
        torch.testing.assert_close(g, w, atol=BF16_ATOL, rtol=0)
    if dead_lane:       # out, and the carried c and h, stay zero
        assert not any(g[0].any() for g in (got[:1] + got[2:]))
    if T > 1:   # from the second step on, bf16 products are not f32's
        w0 = want[0] if save else want
        f32 = lstm_recurrence_reference(xp, mask, wh, rev)
        assert (f32 - got[0]).abs().max() > (w0 - got[0]).abs().max()


@pytest.mark.parametrize("L,H,T,B,route,dead_lane", BF16_CASES)
def test_bf16_backward_kernel_matches_twin(cuda, L, H, T, B, route,
                                           dead_lane):
    """The backward kernel's bf16 variant against the bf16 BPTT twin on
    the same saved states, by its plan or on the route given."""
    xp, mask, wh, rev = _bf16_case(cuda, L, H, T, B, dead_lane)
    out, act, cs, _ = lstm_recurrence_reference(xp, mask, wh, rev,
                                                save=True, bf16=True)
    dout = torch.randn_like(out)
    plan = _bf16_plan("bwd", L, B, H, route) if route else None
    before = _counts("lstm_recurrence_bwd", "lstm_recurrence_bwd_bf16")
    got = _backward_kernel(dout, act, cs, mask, wh, rev, plan=plan,
                           bf16=True)
    assert _counts("lstm_recurrence_bwd", "lstm_recurrence_bwd_bf16") == (
        before[0], before[1] + 1)
    if B <= 8 and H <= 528:
        assert lstm_kernel.card_backward_plan(L, B, H, bf16=True).route == \
            "cluster"
    want = lstm_recurrence_backward_reference(dout, act, cs, mask, wh, rev,
                                              bf16=True)
    torch.testing.assert_close(got, want, atol=BF16_ATOL, rtol=BF16_ATOL)
    if dead_lane:
        assert not got[0].any()


def test_bf16_mode_trains_through_the_bf16_kernels(cuda):
    """Under set_conv_precision("bf16") a MaskedLSTM's training forward and
    backward launch the bf16 variants once each and none of the f32 ones,
    and its gradients equal autograd through the bf16 twins on the CPU."""
    from radmmm_torch.ops import conv
    torch.manual_seed(0)
    lstm = MaskedLSTM(12, 9, spectral_norm=True)
    x = torch.randn(3, 17, 12)
    mask = torch.arange(17)[None, :] < torch.tensor([[17], [5], [1]])
    card = copy.deepcopy(lstm).to(cuda)
    conv.set_conv_precision("bf16")
    try:
        lstm(x, mask).square().sum().backward()
        counts = _counts(*LSTM_KERNELS)
        card(x.to(cuda), mask.to(cuda)).square().sum().backward()
    finally:
        conv.set_conv_precision("f32")
    assert _counts(*LSTM_KERNELS) == (
        counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    for (name, p), q in zip(lstm.named_parameters(), card.parameters()):
        torch.testing.assert_close(q.grad.cpu(), p.grad, atol=1e-3,
                                   rtol=1e-3, msg=name)


def _ctc_inputs(dev, B, T_mel, T_text, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((B, T_mel, T_text), generator=g, device=dev) * 2
    tl = torch.tensor([T_text - i * T_text // (B + 1) for i in range(B)],
                      dtype=torch.int32, device=dev)
    ml = torch.tensor([T_mel - i * T_mel // (B + 1) for i in range(B)],
                      dtype=torch.int32, device=dev)
    tl[-1], ml[-1] = 1, max(T_mel // 5, 1)
    _, emit, _ = _ctc_setup(logits, tl, -1.0)
    return emit, tl, ml


def _close_band(got, want):
    """Equal where finite; both at the NEG_INF floor elsewhere."""
    floor = want < -1e29
    assert torch.equal(got < -1e29, floor)
    torch.testing.assert_close(got[~floor], want[~floor], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("B,T_mel,T_text", [(8, 512, 96), (3, 37, 11),
                                            (4, 2048, 96), (3, 200, 300),
                                            (2, 64, 600), (3, 1, 11)])
def test_ctc_dps_match_twins(cuda, B, T_mel, T_text):
    """The flagship shape, a short one, T_mel 2048 (the emission ring
    wraps 128 times), S past one state a thread (601 states fit 608
    threads; 1,201 take two a thread over 1,024) and a single frame."""
    emit, tl, ml = _ctc_inputs(cuda, B, T_mel, T_text)
    a0, b0 = _counts("ctc_alpha", "ctc_beta")
    alphas = ctc_kernel.ctc_alpha(emit, tl, ml)
    betas = ctc_kernel.ctc_beta(emit, tl, ml)
    assert _counts("ctc_alpha", "ctc_beta") == (a0 + 1, b0 + 1)
    _close_band(alphas, ctc_kernel.ctc_alpha_reference(emit, tl, ml))
    _close_band(betas, ctc_kernel.ctc_beta_reference(emit, tl, ml))


@pytest.mark.parametrize("B,T_mel,T_text,mel_lens", [
    (4, 300, 40, [300, 37, 2, 1]),      # terminal band: mel_len << T_mel, 2, 1
    (3, 60, 11, [0, 1, 2]),             # no DP row at all in two items
    (3, 2048, 96, [2048, 1500, 3]),     # the reversed ring wraps 128 times
    (2, 120, 600, [120, 70]),           # 1,201 states: 19 warps, edges wrap
    (2, 80, 2000, [80, 33]),            # 4,001 states: 32 warps of 4
    (2, 70, 200, [100, 70])])           # mel_len past T_mel
def test_ctc_beta_wavefront_matches_twin(cuda, B, T_mel, T_text, mel_lens):
    """The beta kernel's terminal band (rows >= mel_len - 1 stored, no DP
    row), the wavefront over several warps with its edge ring wrapping, and
    its reversed emission ring wrapping; the plan keeps the block within
    1,024 threads."""
    emit, tl, _ = _ctc_inputs(cuda, B, T_mel, T_text)
    ml = torch.tensor(mel_lens, dtype=torch.int32, device=cuda)
    S = 2 * T_text + 1
    warps, per_lane = ctc_kernel.card_beta_plan(S)
    assert warps * 32 * per_lane >= S and warps <= 32 and per_lane in (1, 2, 4)
    before = launch_counts["ctc_beta"]
    got = ctc_kernel.ctc_beta(emit, tl, ml)
    assert launch_counts["ctc_beta"] == before + 1
    _close_band(got, ctc_kernel.ctc_beta_reference(emit, tl, ml))


def _mas_inputs(dev, B, T_mel, T_text, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand((B, T_mel, T_text), generator=g, device=dev) + 0.01
    a = a / a.sum(-1, keepdim=True)
    tl = torch.tensor([T_text - i * T_text // (B + 1) for i in range(B)],
                      dtype=torch.int32, device=dev)
    ml = torch.tensor([T_mel - i * T_mel // (B + 1) for i in range(B)],
                      dtype=torch.int32, device=dev)
    return a, tl, ml


@pytest.mark.parametrize("B,T_mel,T_text", [(8, 512, 96), (3, 40, 17),
                                            (6, 300, 600), (6, 2048, 96),
                                            (6, 200, 130), (5, 90, 4096),
                                            (3, 200, 1200), (3, 390, 4096)])
def test_mas_matches_twin_bit_for_bit(cuda, B, T_mel, T_text):
    """The flagship shape, a short one, T_text 600 (5 warps of 4 columns
    in the wavefront), T_mel 2048, 130 columns (2 warps, the second with
    2 columns used), 4,096 (32 warps, no room for fill warps), 1,200 (the
    16-row la ring), and 390 x 4,096, the largest T_mel of
    mas_width1_smem's rule there, with no la ring; ragged lengths with the
    corner cases."""
    a, tl, ml = _mas_inputs(cuda, B, T_mel, T_text)
    # corner cases: one token, one frame, no frames, uniform (all ties)
    tl[1], ml[2] = 1, 1
    ml[-1] = 0
    a[0] = 1.0 / T_text
    before = launch_counts["mas_width1"]
    got = alignment.mas_width1(a, tl, ml)
    assert launch_counts["mas_width1"] == before + 1
    log_attn = alignment._log_attention(a, tl)
    want = alignment.mas_width1_reference(log_attn, tl, ml)
    assert torch.equal(got, want)
    assert got[-1].sum() == 0
    warps, cols, fills = alignment.card_plan(T_text)
    assert warps * 32 * cols >= T_text and warps + fills <= 32
    assert cols == min(4, -(-T_text // 32))


def test_mas_refuses_shapes_past_shared_memory(cuda):
    """T_mel x T_text whose choice bits do not fit a block raise."""
    a, tl, ml = _mas_inputs(cuda, 1, 2000, 4000)
    with pytest.raises(ValueError, match="shared memory"):
        alignment.mas_width1(a, tl, ml)


@pytest.mark.parametrize("T_text", [96, 129, 600, 4096])
def test_mas_accepts_the_shapes_of_its_shared_memory_rule(cuda, T_text):
    """The rule is 4 (2 T_text + T_mel ceil(T_text / 32)) bytes within 227
    KB, whatever the wavefront's edge rings: its largest T_mel runs (bit
    for bit with the twin), one more frame raises."""
    lib = cuda_build.load("mas_width1", alignment._declare)
    words = -(-T_text // 32)
    top = (227 * 1024 // 4 - 2 * T_text) // words
    assert lib.mas_width1_smem(top, T_text) == 4 * (2 * T_text + top * words)
    assert lib.mas_width1_smem(top + 1, T_text) > 227 * 1024
    a, tl, ml = _mas_inputs(cuda, 1, top + 1, T_text)
    with pytest.raises(ValueError, match="shared memory"):
        alignment.mas_width1(a, tl, ml)
    a, tl, ml = a[:, :top], tl, torch.clamp(ml, max=top)
    got = alignment.mas_width1(a, tl, ml)
    want = alignment.mas_width1_reference(alignment._log_attention(a, tl),
                                          tl, ml)
    assert torch.equal(got, want)


def _voiced_audio(B: int, T: int, sr: int, seed: int = 0) -> torch.Tensor:
    """B utterances of T samples at ``sr``: a three-harmonic tone with
    vibrato (110-250 Hz, a fifth higher after a noise burst), then
    silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / sr
    out = np.zeros((B, T), np.float32)
    for b in range(B):
        f0 = 110.0 + 140.0 * b / max(B - 1, 1)
        for lo, hi, f in ((0.0, 0.35, f0), (0.45, 0.75, 1.5 * f0)):
            on = (t >= lo * t[-1]) & (t < hi * t[-1])
            ph = 2 * np.pi * f * t + 0.03 * f / 5 * np.sin(2 * np.pi * 5 * t)
            out[b, on] = (0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph)
                          + 0.1 * np.sin(3 * ph))[on]
        burst = (t >= 0.35 * t[-1]) & (t < 0.45 * t[-1])
        out[b, burst] = 0.05 * rng.standard_normal(int(burst.sum()))
    return torch.from_numpy(out)


def _pyin_tables(monkeypatch, audio: torch.Tensor, sr: int) -> tuple:
    """The (log_obs, log_P, log_V) that ``pyin_f0`` hands its Viterbi."""
    seen = []
    real = pitch.viterbi

    def record(*args):
        seen.append(args)
        return real(*args)

    monkeypatch.setattr(pitch, "viterbi", record)
    pitch.pyin_f0(audio, sampling_rate=sr)
    monkeypatch.setattr(pitch, "viterbi", real)
    return seen[0]


def _viterbi_equals_twin(log_obs, log_P, log_V) -> None:
    """The kernel's paths against the twin's on the card and on the CPU,
    bit for bit, and one launch a call."""
    before = launch_counts["pyin_viterbi"]
    got = pitch.viterbi(log_obs, log_P, log_V)
    assert launch_counts["pyin_viterbi"] == before + 1
    card = pitch.viterbi_reference(log_obs, log_P, log_V)
    cpu = pitch.viterbi_reference(log_obs.cpu(), log_P.cpu(), log_V.cpu())
    for g, c, h in zip(got, card, cpu):
        assert g.dtype == torch.int64 and g.shape == log_obs.shape[:2]
        assert torch.equal(g, c)
        assert torch.equal(g.cpu(), h)


@pytest.mark.parametrize("sr", [16000, 22050])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_pyin_viterbi_matches_twin_on_pyins_tables(cuda, monkeypatch, sr, B):
    """K 181 at 513 frames with the tables pYIN builds: 16 kHz (a band of
    width 34) and 22,050 Hz (25), a constant log 1e-12 outside it."""
    audio = _voiced_audio(B, 256 * 512, sr).to(cuda)
    log_obs, log_P, log_V = _pyin_tables(monkeypatch, audio, sr)
    assert log_obs.shape == (B, 513, 2, 181)
    _viterbi_equals_twin(log_obs, log_P, log_V)


@pytest.mark.parametrize("K", [181, 37])
@pytest.mark.parametrize("F", [1, 2, 513])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_pyin_viterbi_matches_twin_on_random_tables(cuda, B, F, K):
    """A random, non-banded log_P and random observations and flips."""
    g = torch.Generator(device=cuda).manual_seed(B * 1000 + F + K)
    log_obs, log_P, log_V = (
        torch.log(torch.rand(shape, generator=g, device=cuda))
        for shape in ((B, F, 2, K), (K, K), (2, 2)))
    _viterbi_equals_twin(log_obs, log_P, log_V)


@pytest.mark.parametrize("K", [181, 37])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_pyin_viterbi_breaks_ties_as_its_twin(cuda, B, K):
    """Every table a multiple of 0.5 in [-4, 0], so sums are exact and
    many maxima tie: the first k, the first v and the first state win."""
    g = torch.Generator(device=cuda).manual_seed(B + K)

    def halves(shape):
        return -torch.randint(0, 9, shape, generator=g,
                              device=cuda).float() / 2

    _viterbi_equals_twin(halves((B, 513, 2, K)), halves((K, K)),
                         halves((2, 2)))


@pytest.mark.parametrize("sr", [16000, 22050])
def test_pyin_on_the_card_equals_pyin_with_the_twin(cuda, monkeypatch, sr):
    """``pyin_f0``'s f0, voicing and p_voiced through the kernel equal its
    results with the twin forced; one launch a call, and one a replay of
    a CUDA graph of it."""
    from radmmm_torch.utils import graphs
    audio = _voiced_audio(8, 256 * 512, sr, seed=1).to(cuda)
    before = launch_counts["pyin_viterbi"]
    got = pitch.pyin_f0(audio, sampling_rate=sr)
    assert launch_counts["pyin_viterbi"] == before + 1
    with monkeypatch.context() as m:
        m.setattr(pitch, "viterbi", pitch.viterbi_reference)
        want = pitch.pyin_f0(audio, sampling_rate=sr)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    g = graphs.Graphed(lambda x: pitch.pyin_f0(x["a"], sampling_rate=sr),
                       graphs.GraphPool(), name="pyin_f0")
    before = launch_counts["pyin_viterbi"]
    for _ in range(3):                  # warm-up, capture and replay, replay
        for a, b in zip(g({"a": audio}), want):
            assert torch.equal(a, b)
    assert launch_counts["pyin_viterbi"] == before + 3


def test_pyin_viterbi_takes_431_bins_and_refuses_432(cuda):
    """A CTA's columns of log_P, the backtrack's staging, the score and
    the receive buffers fit its 227 KB up to K 431 (a cluster of 8); one
    more bin raises, naming the limit the library reports."""
    lib = cuda_build.load("pyin_viterbi", pitch._declare)
    assert lib.pyin_viterbi_max_bins() == 431
    g = torch.Generator(device=cuda).manual_seed(3)
    for K in (431, 432):
        log_obs, log_P, log_V = (
            torch.log(torch.rand(shape, generator=g, device=cuda))
            for shape in ((2, 40, 2, K), (K, K), (2, 2)))
        if K == 431:
            _viterbi_equals_twin(log_obs, log_P, log_V)
            continue
        before = launch_counts["pyin_viterbi"]
        with pytest.raises(ValueError, match="shared memory.*431 bins"):
            pitch.viterbi(log_obs, log_P, log_V)
        assert launch_counts["pyin_viterbi"] == before


@pytest.mark.parametrize("K", [1, 2, 9, 64])
def test_pyin_viterbi_plans_a_cluster_whose_every_cta_owns_a_column(cuda, K):
    """Small K take a smaller cluster (K 9: 5 CTAs of 2 columns), and
    still match the twin."""
    lib = cuda_build.load("pyin_viterbi", pitch._declare)
    C = lib.pyin_viterbi_cluster(K)
    assert 1 <= C <= 8 and (C - 1) * -(-K // C) < K
    g = torch.Generator(device=cuda).manual_seed(K)
    _viterbi_equals_twin(*(torch.log(torch.rand(shape, generator=g,
                                                device=cuda))
                           for shape in ((3, 17, 2, K), (K, K), (2, 2))))


# K5 is CUDA C++, not Triton: a tensor-core implicit GEMM whose tap rows
# are read with a data-dependent halo (zero outside [0, T)), not a fused
# elementwise pass, the case the port keeps Triton for.
@pytest.mark.parametrize("B,T,C_in,C_out", [(32, 256, 1024, 1024),
                                            (3, 250, 1024, 1024),
                                            (2, 37, 24, 40),
                                            (2, 7, 64, 64),
                                            (1, 100, 128, 256),
                                            (2, 300, 1024, 520),
                                            (3, 64, 72, 136)])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8])
def test_conv_softplus_matches_twin(cuda, B, T, C_in, C_out, dilation):
    """The bench shape; T not a multiple of the 128-row tile (at d = 8
    the outer taps of T = 250 reach 16 rows past each end); narrow
    channels; T = 7, where at d = 8 every tap but the centre lies outside
    [0, T); B T below one 128-row tile; Cout 520, not a multiple of the
    256-channel tile; Cin 72, not a multiple of the 64-channel stage."""
    g = torch.Generator(device=cuda).manual_seed(dilation)
    x = torch.randn((B, T, C_in), generator=g, device=cuda)
    w = torch.randn((5, C_in, C_out), generator=g, device=cuda) * 0.02
    b = torch.randn((C_out,), generator=g, device=cuda) * 0.1
    before = launch_counts["conv_softplus"]
    got = wn_kernel.conv_softplus(x, w, b, dilation)
    assert launch_counts["conv_softplus"] == before + 1
    want = wn_kernel.conv_softplus_reference(x, w, b, dilation)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_conv_softplus_copies_a_misaligned_view(cuda):
    """x a bf16 view whose data starts 2 bytes past a 16-byte boundary:
    the TMA tensor map needs an aligned base, so the wrapper copies it."""
    B, T, C = 2, 40, 64
    g = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randn(B * T * C + 1, generator=g, device=cuda).to(
        torch.bfloat16)
    x = flat[1:].view(B, T, C)
    assert x.data_ptr() % 16 != 0
    w = torch.randn((5, C, C), generator=g, device=cuda) * 0.05
    b = torch.randn((C,), generator=g, device=cuda) * 0.1
    got = wn_kernel.conv_softplus(x, w, b, 2)
    want = wn_kernel.conv_softplus_reference(x, w, b, 2)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("C_in,C_out", [(12, 16), (16, 20)])
def test_conv_softplus_refuses_channel_counts_on_the_card(cuda, C_in, C_out):
    before = launch_counts["conv_softplus"]
    with pytest.raises(ValueError, match="multiples of 8"):
        wn_kernel.conv_softplus(torch.zeros((1, 8, C_in), device=cuda),
                                torch.zeros((5, C_in, C_out), device=cuda),
                                torch.zeros(C_out, device=cuda), 1)
    assert launch_counts["conv_softplus"] == before


# K7: ragged masks that are not prefixes, tiles that straddle items, odd
# channel counts (padded to 4 by the wrapper), every dilation, small grids
# whose reduction the plan splits, and items of length 1
@pytest.mark.parametrize("B,T,C_in,C_out,K,dilation,masked,pp", [
    (8, 256, 1024, 1024, 5, 1, True, True),
    (8, 448, 1024, 1024, 5, 8, True, True),
    (3, 50, 131, 130, 5, 4, True, True),
    (2, 37, 12, 8, 5, 2, True, False),
    (1, 96, 1024, 1024, 5, 2, False, True),
    (4, 1, 20, 20, 5, 1, True, True),
    (8, 256, 1135, 1024, 1, 1, False, False),
    (8, 256, 1024, 158, 1, 1, False, False),
    (1, 400, 1136, 1024, 1, 1, False, False)])
def test_wn_conv_matches_twin(cuda, B, T, C_in, C_out, K, dilation, masked,
                              pp):
    """K7's forward (with its row scales), dgrad and wgrad against their
    twins, each launch counted once, and two runs bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(B * T + K)
    x = torch.randn((B, T, C_in), generator=g, device=cuda)
    w = torch.randn((C_out, C_in, K), generator=g, device=cuda) / (
        C_in * K) ** 0.5
    b = torch.randn((C_out,), generator=g, device=cuda)
    dy = torch.randn((B, T, C_out), generator=g, device=cuda)
    mask = None
    if masked:
        lens = torch.arange(B) * 7 % T + 1
        mask = (torch.arange(T)[None] < lens[:, None]).float().to(cuda)
        mask[0, T // 3] = 0.0
    wt = w.permute(2, 1, 0).contiguous()
    wd = (w.flip(2) if K > 1 else w).permute(2, 0, 1).contiguous()
    calls = {
        "wn_conv_fwd": (
            lambda: wn_conv.conv_f32(x, wt, b, mask, dilation, True, pp,
                                     row_scales=masked or pp),
            lambda: (wn_conv.conv_reference(x, wt, b, mask, dilation, True,
                                            pp),
                     wn_conv.row_scales_reference(
                         mask, B, T, K, dilation, pp, torch.float32, cuda)
                     if masked or pp else None)),
        "wn_conv_dgrad": (
            lambda: wn_conv.conv_f32(dy, wd, None, mask, dilation, False,
                                     False, name="wn_conv_dgrad"),
            lambda: (wn_conv.conv_reference(dy, wd, None, mask, dilation,
                                            False, False), None)),
        "wn_conv_wgrad": (
            lambda: (wn_conv.wgrad_f32(dy, x, mask, K, dilation), None),
            lambda: (wn_conv.wgrad_reference(dy, x, mask, K, dilation),
                     None))}
    for name, (kernel, twin) in calls.items():
        before = launch_counts[name]
        got, rs = kernel()
        again, _ = kernel()
        assert launch_counts[name] == before + 2
        want, want_rs = twin()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())
        assert torch.equal(got, again), name
        if want_rs is not None:
            torch.testing.assert_close(rs, want_rs, rtol=1e-6, atol=0)


def test_wn_stack_through_k7_matches_the_modules(cuda, monkeypatch):
    """A WN stack at full width, forward and backward through K7 against
    the same stack through its modules (cuDNN): the output and every
    gradient within 1e-5 of its largest magnitude."""
    from radmmm_torch.ops.coupling import WN
    torch.manual_seed(0)
    wn = WN(79, 1040, 4, 1024, 5).to(cuda)
    with torch.no_grad():
        wn.end.weight.normal_(0, 1e-2)
        wn.end.bias.normal_(0, 1e-2)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((4, 200, 79), generator=g, device=cuda,
                    requires_grad=True)
    c = torch.randn((4, 200, 1040), generator=g, device=cuda,
                    requires_grad=True)
    mask = (torch.arange(200)[None] < torch.tensor([200, 150, 60, 1])[:, None]
            ).to(cuda)
    probe = torch.randn((4, 200, 158), generator=g, device=cuda)

    def run():
        wn.zero_grad()
        z.grad = c.grad = None
        out = wn(z, c, mask)
        (out * probe).sum().backward()
        return [out.detach().clone(), z.grad.clone(), c.grad.clone()] + [
            p.grad.clone() for p in wn.parameters()]

    before = launch_counts["wn_conv_fwd"]
    fused = run()
    assert launch_counts["wn_conv_fwd"] == before + 10
    monkeypatch.setattr(wn_conv, "_routes_to_kernel", lambda m, x: False)
    plain = run()
    for a, b in zip(fused, plain):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def _tiny_tts_config():
    """The CPU tests' tiny model shape, dropout off."""
    from radmmm_torch.models.tts import TTSConfig
    dap = dict(n_speaker_dim=4, n_accent_dim=2, use_accent_embedding=True,
               in_dim=18, out_dim=1, reduction_factor=2, n_backbone_layers=1,
               n_hidden=8, kernel_size=3, p_dropout=0.0, lstm_type="bilstm")
    return TTSConfig(
        n_text_tokens=30, n_text_dim=16, n_speakers=3, n_speaker_dim=4,
        n_accents=2, n_accent_dim=2, n_mel_channels=8, encoder_p_dropout=0.0,
        decoder=dict(n_speaker_dim=4, use_accent=True, n_accent_dim=2,
                     n_text_dim=18, n_f0_dims=1, n_energy_avg_dims=1,
                     n_mel_channels=8, n_flows=2, n_conv_layers_per_step=1,
                     n_early_size=2, n_early_every=2, n_group_size=2,
                     scaling_fn="tanh"),
        f0_predictor=dict(dap, target_offset=-5.0),
        energy_predictor=dict(dap, target_offset=-0.75),
        voiced_predictor=dict(dap),
        duration_predictor=dict(dap, log_target=True))


def test_training_step_on_the_card_matches_the_cpu(cuda):
    """One make_train_step(binarize=True, kl_on=True) at the tiny shape on
    the card and on the CPU from the same weights and batch: every loss
    term and the grad norm within 1e-4 relative (f32, TF32 off, sums in
    another order), every parameter's gradient within 1e-4 of its leaf's
    largest magnitude (at least 1e-6 of the tree's: a leaf whose gradient
    is zero in exact arithmetic holds rounding noise on both sides; the
    worst read 2.8e-6 on an H100), and each kernel launched as often as
    one step needs."""
    import copy
    from radmmm_torch.models.tts import TTSModel
    from radmmm_torch.training import step
    torch.manual_seed(0)
    cpu_model = TTSModel(_tiny_tts_config())
    g = torch.Generator().manual_seed(1)
    B, Tt, Tm = 2, 7, 16
    prior = torch.rand((B, Tm, Tt), generator=g) + 0.1
    batch = {"text": torch.randint(0, 30, (B, Tt), generator=g),
             "input_lengths": torch.tensor([7, 5]),
             "mel": torch.randn((B, Tm, 8), generator=g),
             "output_lengths": torch.tensor([16, 10]),
             "speaker_ids": torch.tensor([0, 2]),
             "accent_ids": torch.tensor([0, 1]),
             "f0": torch.rand((B, Tm), generator=g) * 2 + 4,
             "voiced_mask": (torch.rand((B, Tm), generator=g) > 0.5).float(),
             "energy_avg": torch.rand((B, Tm), generator=g),
             "attn_prior": prior / prior.sum(-1, keepdim=True),
             "speaker_f0_mean": torch.tensor([5.0, 5.2]),
             "speaker_f0_std": torch.tensor([0.3, 0.4])}
    metrics = {}
    models = {"cuda": copy.deepcopy(cpu_model), "cpu": cpu_model}
    for where, m in models.items():
        state = step.create_train_state(m, device=where)
        fn = step.make_train_step(m, step.LossConfig(), True, True)
        b = {k: v.to(where) for k, v in batch.items()}
        before = _counts(*STEP_KERNELS)
        _, met = fn(state, b, torch.Generator(device=where))
        after = _counts(*STEP_KERNELS)
        # K7: 2 flows of one WN layer, 4 convs each way
        want = ((4, 4, 1, 1, 1, 8, 8, 8) if where == "cuda"
                else (0,) * len(STEP_KERNELS))
        assert tuple(a - b for a, b in zip(after, before)) == want
        metrics[where] = {k: v.item() for k, v in met.items()}
    for k, want in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - want) <= 1e-5 + 1e-4 * abs(want), k
    want = dict(models["cpu"].named_parameters())
    tree = max(w.grad.abs().max().item() for w in want.values()
               if w.grad is not None)
    errs = {}
    for name, p in models["cuda"].named_parameters():
        g, w = p.grad, want[name].grad
        assert (g is None) == (w is None), name
        if g is not None:
            diff = (g.cpu() - w).abs().max().item()
            errs[name] = diff / max(w.abs().max().item(), 1e-6 * tree)
    worst = max(errs, key=errs.get)
    print(f"worst leaf gradient error {errs[worst]:.3e} at {worst}")
    assert errs[worst] <= 1e-4, (worst, errs[worst])
