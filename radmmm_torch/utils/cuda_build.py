"""Build and load the port's hand-written CUDA kernels.

Each source under ``radmmm_torch/csrc/`` has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into its own shared library under
``build/radmmm_torch/`` at the repository root, at first use (never at
import), and loaded with ctypes. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them. A library newer than its source
is reused; a header under ``csrc/`` (``*.cuh``) newer than a library
rebuilds it too.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "radmmm_torch"
SOURCES = ("lstm_recurrence", "lstm_recurrence_bwd", "lstm_recurrence_bf16",
           "ctc_band_dp", "mas_width1", "conv_softplus", "marks",
           "pyin_viterbi", "wn_conv_f32")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or than any header
    under csrc/ (which a source may include)."""
    lib = lib_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(names: Iterable[str] = SOURCES, force: bool = False
          ) -> Dict[str, Path]:
    """Compile the named sources (all by default) in parallel, one nvcc
    process each; ptxas's register and shared-memory report goes to
    ``build/radmmm_torch/<name>.ptxas.txt``. Raises with nvcc's errors
    when any build fails."""
    names = list(names)
    todo = [n for n in names if force or _stale(n)]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = lib_path(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        errors = []
        for n, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{n}.cu: nvcc failed ({proc.returncode}):\n"
                              f"{err}")
                continue
            (BUILD_DIR / f"{n}.ptxas.txt").write_text(err)
            os.replace(tmp, lib_path(n))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: lib_path(n) for n in names}


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first if needed);
    ``declare`` sets its functions' argtypes and restypes once."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.radmmm_error_string.argtypes = [ctypes.c_int]
            lib.radmmm_error_string.restype = ctypes.c_char_p
            declare(lib)
            _libs[name] = lib
    return _libs[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch function returned a non-zero CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{lib.radmmm_error_string(err).decode()} "
                           f"({err})")
