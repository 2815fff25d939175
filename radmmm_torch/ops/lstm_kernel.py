"""The masked LSTM recurrence: CUDA kernel wrapper, its plain PyTorch twin
and its launch counter.

Counterpart of ``radmmm_tpu/ops/lstm_pallas.py``. Given the precomputed
input projection, every lane ``l`` runs, for t in its walking order,

    gates = x_proj[l, t] + h @ wh[l]        ; i, f, g, o = split(gates)
    c' = f*c + i*g ; h' = o*tanh(c')
    (h, c) <- (h', c') where mask[t] > 0, else kept ; out[l, t] = h' * mask[t]

A lane with ``reverse`` set walks t from T-1 down to 0, which equals
flipping the sequence, scanning and flipping back: leading padding in
reversed order leaves the zero state untouched. A BiLSTM is one call with
two lanes; the three ganged frame predictors are one call with six.

Tensors on the CPU run ``lstm_recurrence_reference``. Tensors on a CUDA
device launch ``csrc/lstm_recurrence.cu`` (built with nvcc on first use
into ``build/radmmm_torch/`` at the repository root and loaded with ctypes)
or raise; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import torch

# kernel launches since the last reset; chip_smoke.py and the tests read it
launches = 0

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "lstm_recurrence.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "radmmm_torch"
_LIB_NAME = "liblstm_recurrence.so"
_THREADS = 256            # kThreads in the .cu
# hidden units per block, in order of preference (4*hb must divide _THREADS)
_SLICE_WIDTHS = (8, 16, 4, 32, 2, 1)

_lib = None
_lib_lock = threading.Lock()
_plans: dict = {}


def lstm_recurrence_reference(x_proj: torch.Tensor, mask: torch.Tensor,
                              wh: torch.Tensor,
                              reverse: Sequence[bool]) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: a Python loop over time of
    ``torch.bmm`` and elementwise gates.

    x_proj (L, T, B, 4H); mask (T, B) or (L, T, B); wh (L, H, 4H);
    reverse: L flags. Returns out (L, T, B, H), zero at masked frames.
    """
    L, T, B, G = x_proj.shape
    H = G // 4
    m = mask.expand(L, T, B) if mask.dim() == 2 else mask
    lanes = torch.arange(L, device=x_proj.device)
    rev = torch.as_tensor([bool(r) for r in reverse], device=x_proj.device)
    h = x_proj.new_zeros((L, B, H))
    c = x_proj.new_zeros((L, B, H))
    out = x_proj.new_empty((L, T, B, H))
    for s in range(T):
        t = torch.where(rev, T - 1 - s, s)
        gates = x_proj[lanes, t] + torch.bmm(h, wh)
        i, f, g, o = gates.split(H, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        mt = m[lanes, t][..., None]
        h = torch.where(mt > 0, h_new, h)
        c = torch.where(mt > 0, c_new, c)
        out[lanes, t] = h_new * mt
    return out


def lstm_recurrence(x_proj: torch.Tensor, mask: torch.Tensor,
                    wh: torch.Tensor, reverse: Sequence[bool]) -> torch.Tensor:
    """The masked multi-lane LSTM recurrence (see the module docstring).

    CPU tensors run the plain twin; CUDA tensors launch the kernel."""
    global launches
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
    if x_proj.device.type == "cpu":
        return lstm_recurrence_reference(x_proj, mask, wh, reverse)
    if x_proj.device.type != "cuda":
        raise RuntimeError(
            f"lstm_recurrence: no kernel for device {x_proj.device}")
    if L > 64:
        raise ValueError("lstm_recurrence: at most 64 lanes per launch")

    out = torch.empty((L, T, B, H), dtype=torch.float32,
                      device=x_proj.device)
    if T == 0 or B == 0:
        return out
    lib = _library()
    with torch.cuda.device(x_proj.device):
        hb = _plan(lib, L, B, H)
        # double-buffered h of the previous step, shared by a lane's blocks
        hbuf = torch.empty((2, L, B, H), dtype=torch.float32,
                           device=x_proj.device)
        bits = sum(1 << l for l, r in enumerate(reverse) if r)
        err = lib.lstm_recurrence_launch(
            x_proj.data_ptr(), mask.data_ptr(), wh.data_ptr(),
            out.data_ptr(), hbuf.data_ptr(), L, T, B, H,
            T * B if mask.dim() == 3 else 0, bits, hb,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            "lstm_recurrence kernel launch failed: "
            f"{lib.lstm_recurrence_error_string(err).decode()} ({err})")
    launches += 1
    return out


def _plan(lib, L: int, B: int, H: int) -> int:
    """Hidden units per block: the first width in _SLICE_WIDTHS whose grid
    (L * ceil(H / hb) blocks) is co-resident on the card, as the kernel's
    grid-wide barrier needs. Raises when no width fits."""
    key = (torch.cuda.current_device(), L, B, H)
    if key not in _plans:
        for hb in _SLICE_WIDTHS:
            if B * hb > _THREADS:
                continue
            cap = ctypes.c_int(0)
            if lib.lstm_recurrence_capacity(B, H, hb, ctypes.byref(cap)) != 0:
                continue    # this slice's shared memory exceeds a block's
            if L * -(-H // hb) <= cap.value:
                _plans[key] = hb
                break
        else:
            raise RuntimeError(
                f"lstm_recurrence: no slice width puts the L={L}, B={B}, "
                f"H={H} recurrence's blocks on the card at once")
    return _plans[key]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(force: bool = False) -> Path:
    """Compile csrc/lstm_recurrence.cu for sm_90a into the build directory
    (when the library is missing or older than its source). Returns the
    library's path."""
    lib_path = _BUILD_DIR / _LIB_NAME
    if (not force and lib_path.exists()
            and lib_path.stat().st_mtime >= _SRC.stat().st_mtime):
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(tmp), str(_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    (_BUILD_DIR / "lstm_recurrence.ptxas.txt").write_text(res.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.lstm_recurrence_launch.argtypes = [
                vp, vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_longlong,
                ctypes.c_ulonglong, ci, vp]
            lib.lstm_recurrence_launch.restype = ci
            lib.lstm_recurrence_capacity.argtypes = [
                ci, ci, ci, ctypes.POINTER(ci)]
            lib.lstm_recurrence_capacity.restype = ci
            lib.lstm_recurrence_error_string.argtypes = [ci]
            lib.lstm_recurrence_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib
