"""Each cell's run on the CPU at a tiny size, the look for a card
skipped: the reference matches the port (``correct`` true), and with the
timed path broken underneath, ``correct`` comes out false, once for each
fault the cell can have: a step that returns its state unchanged, half of
the batch left out with the mean taken over the rest, an answer altered
where it is produced, a request that fails. (One card: no exchange between cards to leave
out.)"""
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.train import half
from portbench.tests.tiny import tiny_cell

WARMUP_REQUESTS = harness.traffic_kind("serve").WARMUP_REQUESTS

SEED = 2 ** 31 + 101


def _run(name, hooks=None):
    cell = tiny_cell(name)
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    out = kind.run(cell, SEED, 0.5, False, t0=time.perf_counter(),
                   device="cpu", hooks=hooks)
    return out


def _correct(out):
    return all(c["ok"] for c in out["checks"])


@pytest.mark.parametrize("name", ["radmmm.train.b8", "radmmm.serve.single"])
def test_reference_matches_the_port(name):
    out = _run(name)
    assert _correct(out), out["checks"]
    assert out["attempted"] > 0


def _unchanged(prog):
    def step(raw):
        before = [p.detach().clone() for p in prog.model.parameters()]
        met = prog(raw)
        with torch.no_grad():
            for p, q in zip(prog.model.parameters(), before):
                p.copy_(q)
        return met
    return step


def _half_batch(prog):
    return lambda raw: prog(half(raw))


@pytest.mark.parametrize("name", ["radmmm.train.b8"])
@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault):
    assert not _correct(_run(name, {"step": fault}))


class _Altered:
    """The service with each request's first answer altered where it is
    produced: its audio's sign flipped."""

    def __init__(self, service):
        self.service = service

    def synthesize(self, req):
        items, lens = self.service.synthesize(req)
        items = [-np.asarray(items[0])] + list(items[1:])
        return items, lens


@pytest.mark.parametrize("name", ["radmmm.serve.single"])
def test_an_altered_answer_is_not_correct(name):
    assert not _correct(_run(name, {"service": _Altered}))


class _Failing(_Altered):
    """The service failing every third request of the window (the
    set-up's warm-up requests pass)."""

    calls = 0

    def synthesize(self, req):
        self.calls += 1
        if self.calls > WARMUP_REQUESTS and self.calls % 3 == 0:
            raise RuntimeError("planted failure")
        return self.service.synthesize(req)


def test_a_failed_request_is_counted_and_not_correct():
    out = _run("radmmm.serve.single", {"service": _Failing})
    assert out["failed"] > 0
    assert out["attempted"] > out["failed"]
    assert not _correct(out)
