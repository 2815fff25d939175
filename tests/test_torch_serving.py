"""radmmm_torch serving: the two-stage bucketed dispatch against the JAX
package's, the port's artifact round trip, and the HTTP daemon on the CPU.

Audio is int16 PCM: JAX and the port agree within 1 LSB (f32 waveforms
that differ in the last bits can round to neighbouring codes). Mels agree
within 1e-4 (whole-model tolerance, see test_torch_models)."""
import http.client
import io
import json
import struct
import threading
import types
import wave

import jax
import numpy as np
import pytest
import torch

from radmmm_tpu import serving as jax_serving
from radmmm_torch.server import TTSService
from radmmm_torch.serving import (TwoStageTTS, export_tts, load_tts,
                                  make_tts_fn, pick_bucket)
from radmmm_torch.utils import profiling
from tests.test_torch_convert import (jax_small_vocoder, jax_tiny_tts,
                                      torch_tts, torch_vocoder)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TEXT_BUCKETS = [(1, 8), (4, 12)]
FRAME_BUCKETS = (16, 48)


@pytest.fixture(scope="module")
def ported():
    jm, v = jax_tiny_tts()
    gen, gv = jax_small_vocoder()
    return jm, v, gen, gv, torch_tts(jm, v), torch_vocoder(gv)


def _requests(rng):
    """A (1, 5) request and a (3, 10) one: the second fills its (4, 12)
    bucket with a copy of row 0."""
    r1 = (rng.integers(1, 30, (1, 5)).astype(np.int32),
          np.asarray([5], np.int32), np.asarray([1], np.int32),
          np.asarray([0], np.int32), np.asarray([5.0], np.float32),
          np.asarray([0.3], np.float32))
    r2 = (rng.integers(1, 30, (3, 10)).astype(np.int32),
          np.asarray([10, 7, 4], np.int32), np.asarray([0, 2, 1], np.int32),
          np.asarray([0, 1, 1], np.int32),
          np.asarray([5.0, 5.2, 4.9], np.float32),
          np.asarray([0.3, 0.4, 0.35], np.float32))
    return r1, r2


def _jax_two_stage(jm, v, gen, gv):
    """The JAX package's v2 dispatch over jitted stage functions."""
    dur_fn, make_decode = jax_serving.make_two_stage_fns(
        jm, v, sigma=0.0, vocoder=gen, vocoder_vars=gv)
    dur = {bt: types.SimpleNamespace(call=jax.jit(dur_fn))
           for bt in TEXT_BUCKETS}
    dec = {bt: {f: types.SimpleNamespace(call=jax.jit(make_decode(f)))
                for f in FRAME_BUCKETS} for bt in TEXT_BUCKETS}
    return jax_serving._two_stage_call(dur, dec)[0]


def test_two_stage_bucketed_audio_matches_jax(ported, rng, tmp_path):
    jm, v, gen, gv, port, voc = ported
    path = str(tmp_path / "tts.pt")
    export_tts(port, path, vocoder=voc, sigma=0.0, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    served = load_tts(path, device="cpu")
    jax_call = _jax_two_stage(jm, v, gen, gv)
    for req in _requests(rng):
        want, want_lens = jax_call(*req, np.int32(0))
        got, got_lens = served(*req, 0)
        want = np.asarray(want)
        assert got.dtype == torch.int16 and want.dtype == np.int16
        assert got.shape == want.shape     # same frame bucket, same trim
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1


def test_a_request_records_its_spans_and_frames(ported, rng, tmp_path):
    """Under a profiler, a request through TTSService records its spans,
    all of one request, the service's holding the rest, and the frame
    counters of its bucket pick."""
    *_, port, voc = ported
    path = str(tmp_path / "tts.pt")
    export_tts(port, path, vocoder=voc, sigma=0.0, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    service = TTSService(path, hop_length=8, device="cpu")
    text, lens, spk, acc, f0m, f0s = _requests(rng)[1]
    req = {"text_ids": [t[:n].tolist() for t, n in zip(text, lens)],
           "speaker_id": spk.tolist(), "accent_id": acc.tolist(),
           "f0_mean": f0m.tolist(), "f0_std": f0s.tolist()}
    profiling.clear()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _, out_lens = service.synthesize(req)
    finally:
        service._dispatch.close()
    recs = {r.name: r for r in profiling.records()}
    top = recs["service.request"]
    for name in ("dispatch.queue", "serving.pad", "serving.stage_a",
                 "serving.bucket_pick", "serving.stage_b", "service.fetch",
                 "serve.frames_needed", "serve.frames_bucket"):
        r = recs[name]
        assert r.request == top.request, name
        assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns, name
    for name in ("serving.pad", "serving.stage_a", "serving.bucket_pick",
                 "serving.stage_b", "service.fetch"):
        assert recs[name].parent == top.id, name
    need = int(out_lens.max())
    assert recs["serve.frames_needed"].value == need
    assert recs["serve.frames_bucket"].value == pick_bucket(FRAME_BUCKETS,
                                                            need)


def test_single_stage_bucketed_mel_matches_jax(ported, rng, tmp_path):
    jm, v, _, _, port, _ = ported
    path = str(tmp_path / "tts1.pt")
    export_tts(port, path, sigma=0.0, max_frames=48, buckets=TEXT_BUCKETS)
    served = load_tts(path, device="cpu")
    assert served.frame_buckets is None and served.output_kind == "mel"
    fn = jax.jit(jax_serving.make_tts_fn(jm, v, sigma=0.0, max_frames=48))
    jax_call = jax_serving._bucketed_call(
        {bt: types.SimpleNamespace(call=fn) for bt in TEXT_BUCKETS})[0]
    _, req = _requests(rng)
    want, want_lens = jax_call(*req, np.int32(0))
    got, got_lens = served(*req, 0)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_m12_model_serves_as_jax(rng, tmp_path):
    """A model with an LSTMConvDAP duration predictor, a spline first
    step and FiLM-stack couplings, its running statistics moved off their
    init: the two-stage v2 artifact carries them (the loaded buffers are
    the exported ones, and it answers as the in-process model does), and
    its frame counts equal the JAX package's two-stage call on the same
    variables. The mels agree within 5e-4: JAX's quadratic spline
    inverse cancels where a bin's slope barely changes (its result is off
    by up to about 1e-3 there, tests/test_torch_couplings.py and
    tests/test_torch_splines.py), which here moves its mel by 1.4e-4; the
    port's inverse, in the conjugate form, is held to its own forward."""
    import dataclasses

    from radmmm_torch.convert import tts_state_dict_from_jax
    from radmmm_torch.models.tts import TTSConfig, TTSModel
    from tests.test_torch_convert import jax_m12_tts, perturb
    jm, v = jax_m12_tts("spline_film")
    v = perturb(v, seed=8)
    g = np.random.default_rng(9)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + 0.2 * g.uniform(0.5, 1.0, a.shape)).astype(np.float32),
        v["batch_stats"])
    port = TTSModel(TTSConfig(**dataclasses.asdict(jm.config)))
    port.load_state_dict(tts_state_dict_from_jax(v))
    port.eval().cache_inverses()
    path = str(tmp_path / "m12.pt")
    export_tts(port, path, sigma=0.0, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    served = load_tts(path, device="cpu")
    bundle = torch.load(path, weights_only=True)
    stats = {k: t for k, t in bundle["tts_state"].items()
             if k.endswith((".bn.mean", ".bn.var"))}
    assert stats and all(
        torch.equal(t, port.get_buffer(k)) for k, t in stats.items())
    dur_fn, make_decode = jax_serving.make_two_stage_fns(jm, v, sigma=0.0)
    dur = {bt: types.SimpleNamespace(call=jax.jit(dur_fn))
           for bt in TEXT_BUCKETS}
    dec = {bt: {f: types.SimpleNamespace(call=jax.jit(make_decode(f)))
                for f in FRAME_BUCKETS} for bt in TEXT_BUCKETS}
    jax_call = jax_serving._two_stage_call(dur, dec)[0]
    r1, r2 = _requests(rng)
    for req in (r1, r2):
        want, want_lens = jax_call(*req, np.int32(0))
        got, got_lens = served(*req, 0)
        np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)
    text_p = np.zeros((1, 8), np.int32)
    text_p[:, :5] = r1[0]
    mine, _ = TwoStageTTS(port, FRAME_BUCKETS, sigma=0.0)(text_p, *r1[1:], 0)
    assert torch.equal(served(*r1, 0)[0], mine)


def test_artifact_round_trip(ported, rng, tmp_path):
    """A loaded v2 artifact equals the in-process TwoStageTTS at the same
    seed (sigma 0.8: the latent comes from the seeded generator); the
    buckets are kept and an oversize request is refused."""
    *_, port, voc = ported
    path = str(tmp_path / "tts2.pt")
    n = export_tts(port, path, vocoder=voc, sigma=0.8, buckets=TEXT_BUCKETS,
                   frame_buckets=FRAME_BUCKETS)
    assert n > 100_000
    served = load_tts(path, device="cpu")
    assert served.buckets == [(1, 8), (4, 12)]
    assert served.frame_buckets == list(FRAME_BUCKETS)
    assert served.output_kind == "audio"
    r1, _ = _requests(rng)
    a1, l1 = served(*r1, 9)
    text_p = np.zeros((1, 8), np.int32)
    text_p[:, :5] = r1[0]
    a2, l2 = TwoStageTTS(port, FRAME_BUCKETS, sigma=0.8, vocoder=voc)(
        text_p, *r1[1:], 9)
    np.testing.assert_array_equal(a1.numpy(), a2.numpy())
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())
    a3, _ = served(*r1, 10)
    assert not np.array_equal(a1.numpy(), a3.numpy())   # seed matters
    with pytest.raises(ValueError, match="exceeds every exported bucket"):
        served(np.ones((5, 8), np.int32), *[np.repeat(a, 5) for a in r1[1:]],
               0)


def test_pcm_is_quantised_from_the_float_waveform(ported, rng):
    *_, port, voc = ported
    r1, _ = _requests(rng)
    args = (*r1, 4)
    pcm, lens = make_tts_fn(port, sigma=0.8, max_frames=32, vocoder=voc)(
        *args)
    f32, lens2 = make_tts_fn(port, sigma=0.8, max_frames=32, vocoder=voc,
                             pcm_int16=False)(*args)
    assert pcm.dtype == torch.int16 and pcm.shape == (1, 32 * 8)
    want = np.round(np.clip(f32.numpy(), -1, 1) * 32767.0)
    np.testing.assert_array_equal(pcm.numpy(), want.astype(np.int16))
    np.testing.assert_array_equal(lens.numpy(), lens2.numpy())


def test_entry_points_default_to_cuda(ported, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    *_, port, _ = ported
    path = str(tmp_path / "tts.pt")
    export_tts(port, path, buckets=[(1, 8)])
    from radmmm_torch.server import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_tts(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(path, port=0)


@pytest.fixture(scope="module")
def server(ported, tmp_path_factory):
    from radmmm_torch.server import serve
    *_, port, voc = ported
    path = str(tmp_path_factory.mktemp("srv") / "tts.pt")
    export_tts(port, path, vocoder=voc, sigma=0.8, buckets=TEXT_BUCKETS,
               frame_buckets=FRAME_BUCKETS)
    httpd = serve(path, host="127.0.0.1", port=0, hop_length=8,
                  device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request(method, path, body=(json.dumps(body).encode()
                                         if body is not None else None))
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _pcm(blob):
    with wave.open(io.BytesIO(blob)) as w:
        assert (w.getsampwidth(), w.getframerate(), w.getnchannels()) == (
            2, 22050, 1)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def test_http_round_trip(server, rng):
    addr = server.server_address
    status, ctype, data = _request(addr, "GET", "/healthz")
    assert status == 200 and ctype == "application/json"
    info = json.loads(data)
    assert info["buckets"] == [[1, 8], [4, 12]] and info["output"] == "audio"

    ids = rng.integers(1, 30, 6).tolist()
    status, ctype, data = _request(addr, "POST", "/tts",
                                   {"text_ids": ids, "seed": 3})
    assert status == 200 and ctype == "audio/wav"
    pcm = _pcm(data)
    # the daemon trims to the item's frames x hop; the same call in-process
    served = server.service.tts
    audio, lens = served(np.asarray([ids], np.int32),
                         np.asarray([6], np.int32), [0], [0], [5.0], [0.3],
                         3)
    assert pcm.size == int(lens[0]) * 8 > 0
    np.testing.assert_array_equal(pcm, audio[0, :pcm.size].numpy())

    # three texts through the (4, 12) bucket: length-prefixed WAVs
    status, ctype, data = _request(addr, "POST", "/tts", {
        "text_ids": [ids, ids[:3], rng.integers(1, 30, 11).tolist()],
        "speaker_id": [0, 1, 2]})
    assert status == 200 and ctype == "application/octet-stream"
    off, n_wavs = 0, 0
    while off < len(data):
        (n,) = struct.unpack_from("<I", data, off)
        assert _pcm(data[off + 4:off + 4 + n]).size % 8 == 0
        off, n_wavs = off + 4 + n, n_wavs + 1
    assert n_wavs == 3

    # JSON output of the same audio, scaled back to float
    status, ctype, data = _request(addr, "POST", "/tts", {
        "text_ids": ids, "seed": 3, "format": "json"})
    out = json.loads(data)
    assert status == 200 and out["output"] == "audio"
    np.testing.assert_allclose(out["data"][0], pcm / 32767.0, atol=1e-5)


def test_http_errors(server):
    addr = server.server_address
    status, _, data = _request(addr, "POST", "/tts", {"text": "hello"})
    assert status == 400 and b"text_ids" in data
    status, _, data = _request(addr, "POST", "/tts",
                               {"text_ids": list(range(1, 20))})
    assert status == 400 and b"envelope" in data
    status, _, _ = _request(addr, "POST", "/tts", {"seed": 1})
    assert status == 400
    status, _, _ = _request(addr, "GET", "/nope")
    assert status == 404


RAW_TEXT_REQUESTS = (
    {"text": "Hello world, I have 12 dogs and $3.", "language": "en_US"},
    {"text": ["Hola mundo.", "hello"], "language": "es_ES"},
    {"text": "{h ə l ˈoʊ} {w ˈɜ r l d.}", "language": "en_US",
     "is_phonemized": True},
)


@pytest.mark.parametrize("recipe", (False, True))
def test_raw_text_encodes_as_the_jax_daemon(ported, tmp_path, monkeypatch,
                                            recipe):
    """A daemon started with --text-config encodes raw "text" to the ids
    the JAX package's daemon sends, from a data config with phonemizer
    dictionaries and from the shipped 7-language recipe's (whose
    dictionaries are not in the repo: phonemized text only)."""
    import os
    from radmmm_tpu.server import build_text_processor as jax_text_processor
    from radmmm_torch.server import serve
    *_, port, _ = ported
    path = str(tmp_path / "tts.pt")
    export_tts(port, path, buckets=[(1, 8)])
    if recipe:
        monkeypatch.chdir(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cfg = "configs/radmmm_opensource_data_phonemizerless.yaml"
        requests = RAW_TEXT_REQUESTS[2:]
    else:
        g2p = {}
        for lang, words in (("en_US", "hello\thəlˈoʊ\nworld\twˈɜːld\n"),
                            ("es_ES", "hola\tˈola\nmundo\tmˈundo\n")):
            (tmp_path / f"{lang}.tsv").write_text(words, encoding="utf-8")
            g2p[lang] = str(tmp_path / f"{lang}.tsv")
        cfg = str(tmp_path / "data.yaml")
        with open(cfg, "w") as f:
            json.dump({"data": {
                "symbol_set": "radmmm_phonemizer_marker_segregated",
                "cleaner_names": ["radtts_cleaners"],
                "g2p_type": "phonemizer", "phonemizer_cfg": g2p,
                "handle_phoneme_ambiguous": "first"}}, f)
        requests = RAW_TEXT_REQUESTS
    httpd = serve(path, port=0, device="cpu", text_config=cfg)
    try:
        tp = jax_text_processor(cfg)
        for req in requests:
            texts = req["text"] if isinstance(req["text"], list) \
                else [req["text"]]
            want = [tp.encode_text(
                t, language=req["language"],
                is_phonemized=req.get("is_phonemized", False))
                for t in texts]
            assert httpd.service.encode(req) == want
            assert all(len(w) > 2 for w in want)
    finally:
        httpd.server_close()
