"""Training logs: scalars, images and audio; the three plot helpers.

Counterpart of ``radmmm_tpu/utils/logging.py`` (the reference's PTL
self.log, the image and audio logging of training_callbacks.py and
plotting_utils.py). Scalars always go to ``metrics.jsonl`` in the log
directory, one ``{"step": N, "prefix/key": v, ...}`` object per
``scalars()`` call, and to TensorBoard when tensorboardX imports.

The plots are drawn by a small numpy renderer, with no plotting package:
an array becomes an image through a fixed colour table (origin at the
bottom, as the reference's ``imshow(origin="lower")``), curves are drawn
as polylines. The arrays plotted are the JAX package's; the pixels are
not. PNG files are written with zlib.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter
except Exception:  # pragma: no cover
    SummaryWriter = None

# viridis at nine stops, interpolated linearly between them
_COLOURS = np.array([
    [68, 1, 84], [71, 44, 122], [59, 81, 139], [44, 113, 142],
    [33, 144, 141], [39, 173, 129], [92, 200, 99], [170, 220, 50],
    [253, 231, 37]], np.float64)
# line colours of plot_curves_to_numpy, in the order of the curves
_LINES = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                   [214, 39, 40], [148, 103, 189], [140, 86, 75]], np.uint8)
_MIN_SIDE = 256


def colourize(a: np.ndarray) -> np.ndarray:
    """(H, W) values -> (H, W, 3) uint8 over the colour table, scaled from
    the array's minimum to its maximum; row 0 at the bottom."""
    a = np.asarray(a, np.float64)
    lo, hi = (float(a.min()), float(a.max())) if a.size else (0.0, 1.0)
    t = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    x = t * (len(_COLOURS) - 1)
    i = np.clip(np.floor(x).astype(int), 0, len(_COLOURS) - 2)
    f = (x - i)[..., None]
    rgb = _COLOURS[i] * (1 - f) + _COLOURS[i + 1] * f
    return np.ascontiguousarray(np.rint(rgb).astype(np.uint8)[::-1])


def _upscale(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    ry = max(1, -(-_MIN_SIDE // max(h, 1)))
    rx = max(1, -(-_MIN_SIDE // max(w, 1)))
    return np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)


def plot_alignment_to_numpy(alignment: np.ndarray) -> np.ndarray:
    """(T_mel, T_text) attention -> HWC uint8 image, text tokens up, mel
    frames across (plotting_utils.py:52)."""
    return _upscale(colourize(np.asarray(alignment).T))


def plot_mel_to_numpy(mel: np.ndarray) -> np.ndarray:
    """(T, n_mels) -> HWC uint8 image, mel channels up (plotting_utils.py:
    35)."""
    return _upscale(colourize(np.asarray(mel).T))


def plot_curves_to_numpy(curves: Dict[str, np.ndarray],
                         height: int = 200) -> np.ndarray:
    """Named 1-D curves (f0 / energy / voiced) on one axis, one line
    colour each in the order given (plotting_utils.py:81)."""
    arrays = [np.asarray(c, np.float64).reshape(-1) for c in curves.values()]
    n = max([len(c) for c in arrays] + [2])
    width = max(n, _MIN_SIDE)
    img = np.full((height, width, 3), 255, np.uint8)
    finite = [c[np.isfinite(c)] for c in arrays]
    vals = np.concatenate(finite) if finite else np.zeros(1)
    lo, hi = (float(vals.min()), float(vals.max())) if vals.size else (0, 1)
    span = hi - lo if hi > lo else 1.0
    for k, c in enumerate(arrays):
        if len(c) == 0:
            continue
        xs = np.arange(len(c)) * (width - 1) / max(n - 1, 1)
        ys = (height - 1) * (1 - (np.nan_to_num(c, nan=lo) - lo) / span)
        # sample each segment densely enough to leave no gaps
        steps = int(max(width, height)) * 2
        t = np.linspace(0, len(c) - 1, steps)
        px = np.interp(t, np.arange(len(c)), xs)
        py = np.interp(t, np.arange(len(c)), ys)
        img[np.clip(np.rint(py).astype(int), 0, height - 1),
            np.clip(np.rint(px).astype(int), 0, width - 1)] = \
            _LINES[k % len(_LINES)]
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8)[..., :3])
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def _pcm16(wav: np.ndarray) -> np.ndarray:
    w = np.asarray(wav, np.float32)
    peak = max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    return (np.clip(w / peak, -1, 1) * 32767).astype(np.int16)


class TrainLogger:
    """Scalar, image and audio logging: ``metrics.jsonl`` always,
    TensorBoard when tensorboardX imports, and with ``artifact_dir`` every
    image and audio clip also as a file under ``artifact_dir/step_N/``."""

    def __init__(self, log_dir: str, artifact_dir: Optional[str] = None,
                 enabled: bool = True):
        self.enabled = enabled
        if not enabled:
            self.writer = None
            self.artifact_dir = None
            self._jsonl_path = None
            return
        os.makedirs(log_dir, exist_ok=True)
        self.writer = (SummaryWriter(log_dir)
                       if SummaryWriter is not None else None)
        self._jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self.artifact_dir = artifact_dir

    def _artifact_path(self, tag: str, step: int, ext: str) -> Optional[str]:
        if self.artifact_dir is None:
            return None
        d = os.path.join(self.artifact_dir, f"step_{step:07d}")
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, tag.replace("/", "_") + ext)

    def scalars(self, prefix: str, metrics: Dict[str, float], step: int):
        if not self.enabled:
            return
        row = {"step": int(step)}
        for k, v in metrics.items():
            try:
                row[f"{prefix}/{k}"] = float(v)
            except (TypeError, ValueError):
                continue
            if self.writer is not None:
                self.writer.add_scalar(f"{prefix}/{k}", float(v), step)
        with open(self._jsonl_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def image(self, tag: str, img_hwc: np.ndarray, step: int):
        if not self.enabled:
            return
        path = self._artifact_path(tag, step, ".png")
        if path is not None:
            write_png(path, img_hwc)
        if self.writer is not None:
            self.writer.add_image(tag, img_hwc, step, dataformats="HWC")

    def audio(self, tag: str, wav: np.ndarray, step: int,
              sampling_rate: int = 22050):
        if not self.enabled:
            return
        path = self._artifact_path(tag, step, ".wav")
        if path is not None:
            from scipy.io import wavfile
            wavfile.write(path, sampling_rate, _pcm16(wav))
        if self.writer is None:
            return
        # the wav encoded with scipy: tensorboardX's add_audio needs
        # soundfile
        import io
        from scipy.io import wavfile
        from tensorboardX.proto.summary_pb2 import Summary
        buf = io.BytesIO()
        pcm = _pcm16(wav)
        wavfile.write(buf, sampling_rate, pcm)
        audio = Summary.Audio(sample_rate=sampling_rate, num_channels=1,
                              length_frames=pcm.size,
                              encoded_audio_string=buf.getvalue(),
                              content_type="audio/wav")
        self.writer._get_file_writer().add_summary(
            Summary(value=[Summary.Value(tag=tag, audio=audio)]), step)

    def flush(self):
        if self.writer is not None:
            self.writer.flush()
