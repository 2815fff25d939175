"""Host C++ components: the mmap'd feature cache and the batched MAS.

Counterpart of ``radmmm_tpu/native.py``. The port's own sources,
``radmmm_torch/cpp/feature_cache.cc`` and ``mas.cc``, are compiled with
``g++`` into one shared library under ``build/radmmm_torch/native/`` at the
repository root, at first use (never at import), and loaded with ctypes.
The library's name carries a hash of the sources, so an edited source
builds a new one and a library is never older than its sources. A failed
build raises with g++'s errors; there is no Python fallback.

* ``FeatureCacheWriter`` / ``FeatureCache``: an append-only record store
  and its zero-copy reader, safe for concurrent lookups (the LMDB
  replacement of the reference's audio and F0 caches). The file format is
  the JAX package's, byte for byte: a cache written by either package
  reads in the other.
* ``mas_batch_cpu``: width-1 MAS over a batch on host threads, equal bit
  for bit to the card's kernel (``ops/alignment.mas_width1``).
"""
from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from radmmm_torch.utils.cuda_build import BUILD_DIR as _KERNEL_BUILD_DIR

CPP_DIR = Path(__file__).resolve().parent / "cpp"
BUILD_DIR = _KERNEL_BUILD_DIR / "native"
SOURCES = ("feature_cache.cc", "mas.cc")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256()
    for s in SOURCES:
        h.update((CPP_DIR / s).read_bytes())
    return h.hexdigest()[:16]


def build_native(force: bool = False) -> Path:
    """Compile the sources into the library (unless it exists) and return
    its path. The build writes a file of this process's own and renames it
    into place, so processes building at once do not see a partial
    library. Raises RuntimeError with g++'s errors when the build fails."""
    so_path = BUILD_DIR / f"libradmmm_native_{_source_hash()}.so"
    if so_path.exists() and not force:
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
           "-o", str(tmp)] + [str(CPP_DIR / s) for s in SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{so_path.name}:\n{proc.stderr}")
    os.replace(tmp, so_path)
    return so_path


def _declare(lib: ctypes.CDLL) -> None:
    vp, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.cache_writer_open.restype = vp
    lib.cache_writer_open.argtypes = [ctypes.c_char_p]
    lib.cache_writer_put.restype = ctypes.c_int
    lib.cache_writer_put.argtypes = [vp, ctypes.c_char_p, vp, u64]
    lib.cache_writer_close.restype = ctypes.c_int
    lib.cache_writer_close.argtypes = [vp]
    lib.cache_open.restype = vp
    lib.cache_open.argtypes = [ctypes.c_char_p]
    lib.cache_count.restype = u64
    lib.cache_count.argtypes = [vp]
    lib.cache_get.restype = vp
    lib.cache_get.argtypes = [vp, ctypes.c_char_p, ctypes.POINTER(u64)]
    lib.cache_close.restype = None
    lib.cache_close.argtypes = [vp]
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ci = ctypes.c_int
    lib.mas_batch.restype = None
    lib.mas_batch.argtypes = [f32p, f32p, ci, ci, ci, i32p, i32p, ci]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_native()))
            _declare(lib)
            _lib = lib
    return _lib


class FeatureCacheWriter:
    """Append-only writer; the index is written by ``close()`` (or on
    leaving a ``with`` block)."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.cache_writer_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open cache for writing at {path}")

    def put(self, key: str, data: bytes) -> None:
        rc = self._lib.cache_writer_put(self._h, key.encode(), data,
                                        len(data))
        if rc != 0:
            raise OSError(f"cache write failed for {key}")

    def put_array(self, key: str, arr: np.ndarray) -> None:
        """``arr`` as an ``.npy`` record (no pickles)."""
        buf = io.BytesIO()
        np.save(buf, arr, allow_pickle=False)
        self.put(key, buf.getvalue())

    def close(self) -> None:
        if self._h:
            rc = self._lib.cache_writer_close(self._h)
            self._h = None
            if rc != 0:
                raise OSError("cannot write the cache's index")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FeatureCache:
    """mmap'd zero-copy reader; safe for concurrent lookups from the
    loader's threads."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.cache_open(os.fsencode(path))
        if not self._h:
            raise OSError(f"cannot open cache at {path}")

    def __len__(self):
        return int(self._lib.cache_count(self._h))

    def get(self, key: str) -> Optional[bytes]:
        """The record's bytes (a copy), or None when the key is absent."""
        n = ctypes.c_uint64()
        ptr = self._lib.cache_get(self._h, key.encode(), ctypes.byref(n))
        if not ptr:
            return None
        return ctypes.string_at(ptr, n.value)

    def get_array(self, key: str) -> Optional[np.ndarray]:
        raw = self.get(key)
        if raw is None:
            return None
        return np.load(io.BytesIO(raw), allow_pickle=False)

    def close(self) -> None:
        if self._h:
            self._lib.cache_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def mas_batch_cpu(attn: np.ndarray, text_lens: np.ndarray,
                  mel_lens: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """Batched width-1 MAS on host threads (0: one a core). attn (B,
    T_mel, T_text) soft attention; text_lens, mel_lens (B,) within the
    padded sizes. Returns the hard alignment (B, T_mel, T_text) float32,
    zero outside each item's valid region and for items with no text or
    no frames."""
    attn = np.ascontiguousarray(attn, np.float32)
    if attn.ndim != 3:
        raise ValueError(f"mas_batch_cpu: attn must be (B, T_mel, T_text), "
                         f"got {attn.shape}")
    B, T_mel, T_text = attn.shape
    tl = np.ascontiguousarray(text_lens, np.int32)
    ml = np.ascontiguousarray(mel_lens, np.int32)
    for name, lens, top in (("text_lens", tl, T_text),
                            ("mel_lens", ml, T_mel)):
        if lens.shape != (B,) or (lens < 0).any() or (lens > top).any():
            raise ValueError(f"mas_batch_cpu: {name} must be ({B},) within "
                             f"[0, {top}], got {lens}")
    out = np.zeros_like(attn)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    get_lib().mas_batch(attn.ctypes.data_as(f32p), out.ctypes.data_as(f32p),
                        B, T_mel, T_text, ml.ctypes.data_as(i32p),
                        tl.ctypes.data_as(i32p), int(n_threads))
    return out
