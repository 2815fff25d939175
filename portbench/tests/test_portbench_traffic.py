"""The traffic generators: one seed gives the same batches and requests,
another seed others."""
import numpy as np

from portbench import harness
from portbench.tests.tiny import tiny_cell


def _train_arrays(name, seed):
    kind = harness.traffic_kind("train")
    cell = harness.workload(name)
    cs, p = cell["config_spec"], dict(cell["traffic"], pool=2)
    hosts = kind.make_batches(p, cs, kind.make_items(p, cs, seed))
    return [kind._raw(h) for h in hosts]


def _same(a, b):
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a, b))


def test_train_batches_repeat_by_seed():
    a = _train_arrays("radmmm.train.b8", 2 ** 31 + 5)
    assert _same(a, _train_arrays("radmmm.train.b8", 2 ** 31 + 5))
    assert not _same(a, _train_arrays("radmmm.train.b8", 2 ** 31 + 6))


def test_train_batches_hold_the_cell_shapes():
    raws = _train_arrays("radmmm.train.b8", 3)
    kind = harness.traffic_kind("train")
    for r in raws:
        assert r["audio_i16"].shape == (8, 512 * 256)
        assert r["text"].shape == (8, 96)
        lens = kind.lengths(r, 256)
        assert all(48 <= n <= 96 and 256 <= m <= 512 for n, m in lens)


def test_requests_repeat_by_seed():
    kind = harness.traffic_kind("serve")
    cell = harness.workload("radmmm.serve.single")
    cs, p = cell["config_spec"], dict(cell["traffic"], requests=50)
    a = kind.make_requests(p, cs, 2 ** 31 + 9)
    assert a == kind.make_requests(p, cs, 2 ** 31 + 9)
    assert a != kind.make_requests(p, cs, 2 ** 31 + 10)
    assert all(len(r["text_ids"]) == p["texts"] for r in a)
    # LJSpeech's shortest and longest utterances at its speech rate, in
    # the artifact's text bucket
    assert all(17 <= len(t) <= 154 <= p["buckets"][0][1]
               for r in a for t in r["text_ids"])


def test_request_lengths_follow_the_cited_distribution():
    """Every block of requests holds the same token counts, whose mean
    is LJSpeech's mean utterance (6.57 s) at its speech rate."""
    kind = harness.traffic_kind("serve")
    cell = harness.workload("radmmm.serve.single")
    cs, p = cell["config_spec"], dict(cell["traffic"], requests=100)
    n = kind.BLOCK
    lens = [len(r["text_ids"][0]) for r in kind.make_requests(p, cs, 5)]
    blocks = [sorted(lens[s:s + n]) for s in range(0, len(lens), n)]
    assert all(b == blocks[0] for b in blocks)
    assert abs(np.mean(lens) - 6.57 * p["tokens_per_second"]) < 1.5
    assert kind.triangular_quantile(0.0, 1.0, 2.0, 4.0) == 1.0
    assert kind.triangular_quantile(1.0, 1.0, 2.0, 4.0) == 4.0
    assert kind.triangular_quantile(1 / 3, 1.0, 2.0, 4.0) == 2.0


def test_tiny_cells_keep_their_kind():
    for name in ("radmmm.train.b8", "radmmm.serve.single"):
        assert tiny_cell(name)["traffic"]["kind"] in ("train", "serve")
