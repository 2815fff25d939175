"""radmmm_torch.native, the port's host C++ (radmmm_torch/cpp/): the
library's build, the feature cache (round trip, concurrent reads, and the
file format shared with radmmm_tpu.native both ways, byte for byte) and
mas_batch_cpu against the K3 twin (radmmm_torch/ops/alignment.py) bit for
bit, on ragged lengths, text_len 1, zero lengths and ties."""
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from radmmm_tpu import native as jax_native
from radmmm_torch import native
from radmmm_torch.ops.alignment import mas_width1
from tests.test_alignment import soft_attn
from tests.test_torch_threads import one_torch_thread  # noqa: F401


def test_native_builds_under_the_port_build_dir():
    so = native.build_native()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("radmmm_torch", "native")
    assert native._source_hash() in so.name
    # the port's own sources, never the JAX package's cpp/
    assert native.CPP_DIR.parts[-2:] == ("radmmm_torch", "cpp")


def _records(rng):
    arrs = {f"utt{i}": rng.standard_normal((80, 10 + i)).astype(np.float32)
            for i in range(20)}
    arrs["f0::wavs/ü.wav"] = np.arange(12, dtype=np.int16).reshape(3, 4)
    return arrs


def test_feature_cache_roundtrip(tmp_path, rng):
    path = str(tmp_path / "cache")
    arrs = _records(rng)
    with native.FeatureCacheWriter(path) as w:
        for k, a in arrs.items():
            w.put_array(k, a)
        w.put("raw", b"hello bytes")
        w.put("empty", b"")
    with native.FeatureCache(path) as c:
        assert len(c) == len(arrs) + 2
        for k, a in arrs.items():
            got = c.get_array(k)
            assert got.dtype == a.dtype
            np.testing.assert_array_equal(got, a)
        assert c.get("raw") == b"hello bytes"
        assert c.get("empty") == b""
        assert c.get("missing") is None
        assert c.get_array("nope") is None


def test_cache_open_errors(tmp_path):
    with pytest.raises(OSError, match="cannot open cache"):
        native.FeatureCache(str(tmp_path / "absent"))
    with pytest.raises(OSError, match="for writing"):
        native.FeatureCacheWriter(str(tmp_path / "no_dir" / "cache"))


def test_cache_concurrent_reads(tmp_path):
    """More reader threads than cores, a short switch interval: every
    lookup returns its own record."""
    path = str(tmp_path / "cc")
    with native.FeatureCacheWriter(path) as w:
        for i in range(200):
            w.put(f"k{i}", bytes([i % 256]) * (i + 1))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with native.FeatureCache(path) as c:
            def read(i):
                return c.get(f"k{i % 200}")
            with ThreadPoolExecutor(16) as pool:
                results = list(pool.map(read, range(2000)))
    finally:
        sys.setswitchinterval(old)
    for i, r in enumerate(results):
        j = i % 200
        assert r == bytes([j % 256]) * (j + 1), i


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_format_shared_with_jax(tmp_path, rng, writer):
    """A cache written by either package reads in the other, and both
    writers make the same bytes from the same records."""
    arrs = _records(rng)
    files = {}
    for name, mod in (("port", native), ("jax", jax_native)):
        path = str(tmp_path / name)
        with mod.FeatureCacheWriter(path) as w:
            for k, a in arrs.items():
                w.put_array(k, a)
            w.put("raw", b"\x00\x01bytes")
        files[name] = path
    for ext in (".dat", ".idx"):
        assert (open(files["port"] + ext, "rb").read()
                == open(files["jax"] + ext, "rb").read()), ext
    reader = jax_native if writer == "port" else native
    with reader.FeatureCache(files[writer]) as c:
        assert len(c) == len(arrs) + 1
        for k, a in arrs.items():
            np.testing.assert_array_equal(c.get_array(k), a)
        assert c.get("raw") == b"\x00\x01bytes"


def _ties(rng):
    """Uniform attention: every comparison of the DP is a tie."""
    return (np.full((2, 9, 4), 0.25, np.float32), np.array([4, 3], np.int32),
            np.array([9, 6], np.int32))


MAS_CASES = {
    # ragged: mel_len < T_mel and text_len < T_text on most items
    "ragged": lambda rng: (soft_attn(rng, 4, 57, 17),
                           np.array([17, 12, 8, 5], np.int32),
                           np.array([57, 40, 21, 11], np.int32)),
    # text_len 1 (all frames on token 0), mel_len 1, and a square item
    "degenerate": lambda rng: (soft_attn(rng, 3, 10, 5),
                               np.array([1, 5, 3], np.int32),
                               np.array([10, 1, 3], np.int32)),
    # no text, no frames, and both: no path at all
    "zero_lengths": lambda rng: (soft_attn(rng, 4, 12, 6),
                                 np.array([0, 6, 0, 4], np.int32),
                                 np.array([12, 0, 0, 7], np.int32)),
    "ties": _ties,
}


@pytest.mark.parametrize("case", sorted(MAS_CASES))
def test_mas_batch_cpu_matches_k3_twin(rng, case):
    attn, text_lens, mel_lens = MAS_CASES[case](rng)
    got = native.mas_batch_cpu(attn, text_lens, mel_lens)
    want = mas_width1(torch.from_numpy(attn), torch.from_numpy(text_lens),
                      torch.from_numpy(mel_lens)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == attn.shape
    for b in range(attn.shape[0]):
        assert got[b, mel_lens[b]:].sum() == 0
        assert got[b, :, text_lens[b]:].sum() == 0
        if text_lens[b] and mel_lens[b]:
            # one token a frame on the valid region; row 0 also marks
            # token 0 (the reference's trailing write)
            np.testing.assert_array_equal(
                got[b, 1:mel_lens[b], :text_lens[b]].sum(-1), 1.0)
            assert got[b, 0, 0] == 1.0
            # and the JAX package's library agrees where it has a path
            ref = jax_native.mas_batch_cpu(attn[b:b + 1], text_lens[b:b + 1],
                                           mel_lens[b:b + 1])
            np.testing.assert_array_equal(got[b], ref[0])


def test_mas_batch_cpu_threads_agree(rng):
    attn = soft_attn(rng, 7, 33, 11)
    tl = np.array([11, 10, 9, 8, 7, 6, 5], np.int32)
    ml = np.array([33, 30, 27, 24, 21, 18, 15], np.int32)
    one = native.mas_batch_cpu(attn, tl, ml, n_threads=1)
    for n in (0, 3, 16):
        np.testing.assert_array_equal(
            native.mas_batch_cpu(attn, tl, ml, n_threads=n), one)


@pytest.mark.parametrize("bad", ["text_too_long", "mel_too_long", "negative",
                                 "wrong_batch", "not_3d"])
def test_mas_batch_cpu_checks_its_inputs(rng, bad):
    attn = soft_attn(rng, 2, 8, 4)
    tl, ml = np.array([4, 3], np.int32), np.array([8, 5], np.int32)
    if bad == "text_too_long":
        tl[0] = 5
    elif bad == "mel_too_long":
        ml[1] = 9
    elif bad == "negative":
        tl[1] = -1
    elif bad == "wrong_batch":
        tl = tl[:1]
    else:
        attn = attn[0]
    with pytest.raises(ValueError, match="mas_batch_cpu"):
        native.mas_batch_cpu(attn, tl, ml)


def test_build_failure_raises_with_the_compiler_errors(tmp_path, monkeypatch):
    bad = tmp_path / "cpp"
    bad.mkdir()
    (bad / "feature_cache.cc").write_text("this is not C++\n")
    (bad / "mas.cc").write_text("")
    monkeypatch.setattr(native, "CPP_DIR", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*\n.*error"):
        native.build_native()
    assert not list((tmp_path / "build").glob("*.so"))


def test_get_lib_loads_once_across_threads():
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(native.get_lib()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(libs) == 8 and all(lib is libs[0] for lib in libs)


def test_import_check_walks_the_cache_slice():
    """The modules of the cache slice are among those that
    tests/test_torch_convert.py's import check walks, and the port's
    library holds its own copies of the C++ sources."""
    import pkgutil
    import radmmm_torch
    walked = {m.name for m in pkgutil.walk_packages(radmmm_torch.__path__,
                                                    "radmmm_torch.")}
    assert {"radmmm_torch.native", "radmmm_torch.data.f0_cache",
            "radmmm_torch.scripts.build_audio_cache",
            "radmmm_torch.scripts.build_f0_cache",
            "radmmm_torch.scripts.compute_speaker_prosody_statistics"
            } <= walked
    assert all((native.CPP_DIR / s).is_file() for s in native.SOURCES)
