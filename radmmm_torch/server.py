"""HTTP serving daemon over the port's serving artifact.

Counterpart of ``radmmm_tpu/server.py``:

    python -m radmmm_torch --artifact tts.pt --port 8001 [--device cuda]
        [--text-config data.yaml]

API:
    GET  /healthz  -> {"status": "ok", "buckets": [[B, T], ...],
                       "output": "audio" | "mel", "sampling_rate": sr}
    POST /tts      -> audio/wav (or JSON mel) for
        {"text_ids": [[...], ...]}  or  {"text": "..." | ["...", ...],
                                         "language": "en_US",
                                         "is_phonemized": false}
        optional: "speaker_id", "accent_id", "f0_mean", "f0_std", "seed",
                  "format": "wav" | "json"

Raw ``"text"`` is encoded by the port's text frontend, built from the
data-config yaml given with ``--text-config``; without one, send
pre-encoded ``text_ids``.

Concurrency: handler threads do the host work (parsing, padding, the
device-to-host fetch, WAV encoding) while one dispatcher thread owns the
order of device work. CUDA work is asynchronous, so request i+1 is queued
on the device while request i's output is fetched on its handler thread.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import io
import json
import queue
import struct
import threading
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from radmmm_torch.utils import profiling


class DeviceDispatcher:
    """Runs every call of ``fn`` on one thread, in arrival order; callers
    wait on their own future (bounded by ``timeout``). While a profiler
    runs, a call's wait in the queue is span ``dispatch.queue`` and its
    spans join the caller's request (``utils/profiling``)."""

    def __init__(self, fn, depth: int = 8, timeout: float = 120.0):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = False
        self._timeout = timeout
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            args, fut, handoff = item
            with profiling.handed("dispatch.queue", handoff):
                try:
                    fut.set_result(self._fn(*args))
                except Exception as e:  # noqa: BLE001 - to the caller
                    fut.set_exception(e)

    def __call__(self, *args):
        if self._closed:
            raise RuntimeError("DeviceDispatcher is closed")
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._q.put((args, fut, profiling.handoff()))
        return fut.result(timeout=self._timeout)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._thread.join(timeout=5.0)


def _wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """int16 PCM (or float in [-1, 1]) -> 16-bit mono WAV bytes."""
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16:
        i16 = pcm.astype("<i2", copy=False)
    else:
        x = np.clip(pcm.astype(np.float32, copy=False), -1.0, 1.0)
        i16 = (x * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(i16.tobytes())
    return buf.getvalue()


class TTSService:
    """Request -> artifact call -> trimmed per-item outputs."""

    def __init__(self, artifact_path: str, sampling_rate: int = 22050,
                 hop_length: int = 256, defaults: Optional[dict] = None,
                 device: str = "cuda", text_processor=None):
        from radmmm_torch.serving import load_tts

        self.tp = text_processor
        self.tts = load_tts(artifact_path, device=device)
        self._dispatch = DeviceDispatcher(self.tts)
        self.sr = sampling_rate
        self.hop = hop_length
        self.defaults = {"speaker_id": 0, "accent_id": 0,
                         "f0_mean": 5.0, "f0_std": 0.3, "seed": 0,
                         **(defaults or {})}
        self.output_kind = self.tts.output_kind
        self.max_batch = max(b for b, _ in self.tts.buckets)
        self.max_text = max(t for _, t in self.tts.buckets)

    def info(self) -> dict:
        return {"status": "ok",
                "buckets": [list(b) for b in self.tts.buckets],
                "output": self.output_kind,
                "sampling_rate": self.sr}

    def encode(self, req: dict) -> list:
        if "text_ids" in req:
            seqs = req["text_ids"]
            if seqs and isinstance(seqs[0], int):
                seqs = [seqs]
            return [list(map(int, s)) for s in seqs]
        if "text" not in req:
            raise ValueError("request needs 'text' or 'text_ids'")
        if self.tp is None:
            raise ValueError("raw 'text' needs the daemon started with "
                             "--text-config; send 'text_ids' instead")
        texts = req["text"]
        if isinstance(texts, str):
            texts = [texts]
        return [self.tp.encode_text(
            t, language=req.get("language"),
            is_phonemized=bool(req.get("is_phonemized", False)))
            for t in texts]

    def synthesize(self, req: dict):
        with profiling.span("service.request", new_request=True):
            return self._synthesize(req)

    def _synthesize(self, req: dict):
        seqs = self.encode(req)
        b = len(seqs)
        t = max(len(s) for s in seqs)
        if b > self.max_batch or t > self.max_text:
            raise ValueError(
                f"request ({b} texts, longest {t} tokens) exceeds the "
                f"artifact envelope (max batch {self.max_batch}, max text "
                f"{self.max_text})")
        text = np.zeros((b, t), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, s in enumerate(seqs):
            text[i, :len(s)] = s
            lens[i] = len(s)

        def per_item(key, dtype):
            arr = np.asarray(req.get(key, self.defaults[key]), dtype)
            return np.full((b,), arr, dtype) if arr.ndim == 0 else arr

        out, out_lens = self._dispatch(
            text, lens,
            per_item("speaker_id", np.int32),
            per_item("accent_id", np.int32),
            per_item("f0_mean", np.float32),
            per_item("f0_std", np.float32),
            int(req.get("seed", self.defaults["seed"])))
        with profiling.span("service.fetch"):
            # the blocking device-to-host copy happens here, on the
            # handler thread, while the dispatcher queues the next request
            out, out_lens = out.cpu().numpy(), out_lens.cpu().numpy()
            items = []
            for i in range(b):
                n = int(out_lens[i])
                items.append(out[i, :n * self.hop]
                             if self.output_kind == "audio" else out[i, :n])
        return items, out_lens


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path in ("/healthz", "/"):
                self._json(200, service.info())
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/tts":
                self._json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                items, lens = service.synthesize(req)
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 - surface to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            fmt = req.get("format",
                          "wav" if service.output_kind == "audio" else "json")
            if fmt == "wav" and service.output_kind == "audio":
                if len(items) == 1:
                    self._send(200, _wav_bytes(items[0], service.sr),
                               "audio/wav")
                else:
                    # several items: length-prefixed concatenation of WAVs
                    out = io.BytesIO()
                    for it in items:
                        blob = _wav_bytes(it, service.sr)
                        out.write(struct.pack("<I", len(blob)))
                        out.write(blob)
                    self._send(200, out.getvalue(),
                               "application/octet-stream")
            else:
                self._json(200, {
                    "lens": [int(x) for x in lens],
                    "output": service.output_kind,
                    "data": [(it.astype(np.float32) / 32767.0
                              if it.dtype == np.int16
                              else it.astype(np.float32)).round(5).tolist()
                             for it in items]})

    return Handler


def build_text_processor(config_path: str):
    """TextProcessing from a data-config yaml (the reference's schema):
    the training CLI's translation, its text settings only."""
    from radmmm_torch.text.processing import TextProcessing
    from radmmm_torch.utils.config import (load_configs,
                                           translate_reference_data_config)

    kw = translate_reference_data_config(load_configs([config_path]))
    return TextProcessing(
        kw.get("symbol_set", "radmmm_phonemizer_marker_segregated"),
        list(kw.get("cleaner_names", ("basic_cleaners",))),
        kw.get("heteronyms_path"), kw.get("phoneme_dict_path"),
        p_phoneme=kw.get("p_phoneme", 1.0),
        handle_phoneme=kw.get("handle_phoneme", "word"),
        handle_phoneme_ambiguous=kw.get("handle_phoneme_ambiguous",
                                        "ignore"),
        prepend_space_to_text=kw.get("prepend_space_to_text", True),
        append_space_to_text=kw.get("append_space_to_text", True),
        add_bos_eos_to_text=kw.get("add_bos_eos_to_text", False),
        g2p_type=kw.get("g2p_type", "phonemizer"),
        phonemizer_cfg=kw.get("phonemizer_cfg"))


def serve(artifact: str, host: str = "127.0.0.1", port: int = 8001,
          sampling_rate: int = 22050, hop_length: int = 256,
          device: str = "cuda",
          text_config: Optional[str] = None) -> ThreadingHTTPServer:
    tp = build_text_processor(text_config) if text_config else None
    service = TTSService(artifact, sampling_rate, hop_length, device=device,
                         text_processor=tp)

    class _Server(ThreadingHTTPServer):
        # a clean shutdown also stops the dispatch thread
        def server_close(self):
            super().server_close()
            service._dispatch.close()

    httpd = _Server((host, port), make_handler(service))
    httpd.service = service
    return httpd


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8001)
    ap.add_argument("--sampling-rate", type=int, default=22050)
    ap.add_argument("--hop-length", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--text-config", default=None,
                    help="data-config yaml for raw-text requests")
    args = ap.parse_args()
    httpd = serve(args.artifact, args.host, args.port, args.sampling_rate,
                  args.hop_length, args.device, args.text_config)
    info = httpd.service.info()
    print(f"serving {args.artifact} on http://{args.host}:"
          f"{httpd.server_address[1]} (output={info['output']}, "
          f"buckets={info['buckets']})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
