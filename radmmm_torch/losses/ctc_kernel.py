"""The CTC alpha and beta band DPs: CUDA kernel wrappers, their plain
PyTorch twins and their launch counters.

Counterpart of ``radmmm_tpu/losses/ctc_pallas.py``. With S = 2*T_text + 1
states (even: blank, odd: text token (s+1)/2, every label distinct) and
per-state emissions ``emit_all`` (B, T_mel, S):

* ``ctc_alpha`` returns every row of the forward DP (T_mel, B, S), rows
  frozen past each item's mel length (the scan's carry);
* ``ctc_beta`` returns every row of the reverse DP (T_mel, B, S), rows at
  and past mel_len - 1 at the terminal band.

NEG_INF is the finite -1e30, so 0 * NEG_INF stays 0. The twins are the JAX
package's scans (``losses/ctc.py`` ``_alpha_scan`` and the beta scan of
``_ctc_bwd``) written in torch. CPU tensors run them; CUDA tensors launch
``csrc/ctc_band_dp.cu`` (built by ``utils/cuda_build``) or raise.
"""
from __future__ import annotations

import ctypes

import torch

from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.launches import launched

NEG_INF = -1e30


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


def _skip(S: int, device) -> torch.Tensor:
    """0 into (alpha) / out of (beta) odd label states, NEG_INF for even."""
    s = torch.arange(S, device=device)
    return torch.where(s % 2 == 1, 0.0, NEG_INF)


def ctc_alpha_reference(emit_all: torch.Tensor, text_lens: torch.Tensor,
                        mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the alpha kernel: a loop over mel rows."""
    B, T, S = emit_all.shape
    s = torch.arange(S, device=emit_all.device)
    state_valid = s[None, :] <= 2 * text_lens[:, None]
    alpha = torch.where((s[None, :] <= 1) & state_valid, emit_all[:, 0],
                        NEG_INF)
    skip = _skip(S, emit_all.device)
    neg = emit_all.new_full((B, 1), NEG_INF)
    neg2 = emit_all.new_full((B, 2), NEG_INF)
    out = [alpha]
    for t in range(1, T):
        prev1 = torch.cat([neg, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([neg2, alpha[:, :-2]], dim=1) + skip
        new = torch.where(state_valid,
                          _lse3(alpha, prev1, prev2) + emit_all[:, t],
                          NEG_INF)
        alpha = torch.where((t < mel_lens)[:, None], new, alpha)
        out.append(alpha)
    return torch.stack(out)


def ctc_beta_reference(emit_all: torch.Tensor, text_lens: torch.Tensor,
                       mel_lens: torch.Tensor) -> torch.Tensor:
    """Plain twin of the beta kernel: a reverse loop over mel rows."""
    B, T, S = emit_all.shape
    s = torch.arange(S, device=emit_all.device)
    terminal = torch.where((s[None, :] == 2 * text_lens[:, None])
                           | (s[None, :] == 2 * text_lens[:, None] - 1),
                           0.0, NEG_INF)
    skip = _skip(S, emit_all.device)
    neg = emit_all.new_full((B, 1), NEG_INF)
    neg2 = emit_all.new_full((B, 2), NEG_INF)
    beta = terminal
    out = [beta]
    for t in range(T - 2, -1, -1):
        q = beta + emit_all[:, t + 1]
        n1 = torch.cat([q[:, 1:], neg], dim=1)
        n2 = torch.cat([q[:, 2:], neg2], dim=1) + skip
        beta = torch.where((t >= mel_lens - 1)[:, None], terminal,
                           _lse3(q, n1, n2))
        out.append(beta)
    return torch.stack(out[::-1])


def _check(emit_all, text_lens, mel_lens):
    if emit_all.dim() != 3 or emit_all.dtype != torch.float32:
        raise TypeError("ctc DP: emit_all must be (B, T_mel, S) float32, "
                        f"got {tuple(emit_all.shape)} {emit_all.dtype}")
    B = emit_all.shape[0]
    for name, t in (("text_lens", text_lens), ("mel_lens", mel_lens)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise TypeError(f"ctc DP: {name} must be ({B},) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ctc DP: {name} must be contiguous")
        if t.device != emit_all.device:
            raise ValueError(f"ctc DP: {name} is on {t.device}, emit_all "
                             f"on {emit_all.device}")
    if not emit_all.is_contiguous():
        raise ValueError("ctc DP: emit_all must be contiguous")
    if emit_all.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"ctc DP: no kernel for device {emit_all.device}")


def _launch(which: str, emit_all, text_lens, mel_lens) -> torch.Tensor:
    B, T, S = emit_all.shape
    out = torch.empty((T, B, S), dtype=torch.float32,
                      device=emit_all.device)
    if T == 0 or B == 0:
        return out
    lib = cuda_build.load("ctc_band_dp", _declare)
    with torch.cuda.device(emit_all.device):
        err = getattr(lib, f"ctc_{which}_launch")(
            emit_all.data_ptr(), text_lens.data_ptr(), mel_lens.data_ptr(),
            out.data_ptr(), B, T, S,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(lib, err, f"ctc_{which}")
    return out


def card_beta_plan(S: int) -> tuple:
    """(warps, states a lane) of the beta kernel's launch for S states."""
    lib = cuda_build.load("ctc_band_dp", _declare)
    warps, per_lane = ctypes.c_int(), ctypes.c_int()
    lib.ctc_beta_plan(S, ctypes.byref(warps), ctypes.byref(per_lane))
    return warps.value, per_lane.value


def ctc_alpha(emit_all: torch.Tensor, text_lens: torch.Tensor,
              mel_lens: torch.Tensor) -> torch.Tensor:
    """Every row of the forward DP, (T_mel, B, S). text_lens and mel_lens
    are (B,) int32 on emit_all's device."""
    _check(emit_all, text_lens, mel_lens)
    if emit_all.device.type == "cpu":
        return ctc_alpha_reference(emit_all, text_lens, mel_lens)
    out = _launch("alpha", emit_all, text_lens, mel_lens)
    launched("ctc_alpha")
    return out


def ctc_beta(emit_all: torch.Tensor, text_lens: torch.Tensor,
             mel_lens: torch.Tensor) -> torch.Tensor:
    """Every row of the reverse DP, (T_mel, B, S)."""
    _check(emit_all, text_lens, mel_lens)
    if emit_all.device.type == "cpu":
        return ctc_beta_reference(emit_all, text_lens, mel_lens)
    out = _launch("beta", emit_all, text_lens, mel_lens)
    launched("ctc_beta")
    return out


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ctc_alpha_launch, lib.ctc_beta_launch):
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        fn.restype = ci
    lib.ctc_beta_plan.argtypes = [ci, ctypes.POINTER(ci), ctypes.POINTER(ci)]
    lib.ctc_beta_plan.restype = None
