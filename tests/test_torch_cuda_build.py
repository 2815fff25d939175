"""The kernel build's staleness rule, on the CPU: a library is rebuilt when
its source or any header under csrc/ is newer than it."""
import os

import pytest
import torch

from radmmm_torch.utils import cuda_build


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread for the module's tests, as in every port test
    file (tests/test_torch_threads.py says why). Defined here, not
    imported from ``tests``: where the card's tests run, an installed
    package of that name may shadow the repository's tests directory."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", build)
    (csrc / "k.cu").write_text("// source\n")
    (csrc / "shared.cuh").write_text("// header\n")
    return csrc, build


def _age(path, seconds):
    os.utime(path, (seconds, seconds))


@pytest.mark.parametrize("newer,stale", [(None, False), ("k.cu", True),
                                         ("shared.cuh", True)])
def test_a_newer_source_or_header_makes_the_library_stale(tree, newer,
                                                          stale):
    csrc, build = tree
    lib = build / "libk.so"
    lib.write_bytes(b"")
    for p in (csrc / "k.cu", csrc / "shared.cuh"):
        _age(p, 1_000)
    _age(lib, 2_000)
    if newer:
        _age(csrc / newer, 3_000)
    assert cuda_build._stale("k") is stale


def test_a_missing_library_is_stale(tree):
    assert cuda_build._stale("k")
