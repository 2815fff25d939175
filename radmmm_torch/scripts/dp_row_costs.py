"""What a row of the CTC and MAS DP kernels costs, and where it goes, on
the card.

    python -m radmmm_torch.scripts.dp_row_costs [--baseline CSRC_DIR]

Builds copies of ``csrc/ctc_band_dp.cu`` (K1 alpha, K2 beta) and
``csrc/mas_width1.cu`` (K3) into ``build/dp_row_costs/``, each copy with
one part of the row taken out, and times every copy's kernel at the
flagship shape (B 8, T_text 96, T_mel 512, full lengths; CUDA events over
50 launches of the raw C entry point) at mel_len 512 and 256. The
difference over the 256 rows between them is the kernel's time a row,
free of launch, set-up and tail. A copy with a part taken out computes
something else; only the unchanged sources are checked against the plain
twins. The parts:

- K1: the emission copies (``nofetch``), the accurate lse3 (``nolse``:
  max in its place);
- K2: the emission copies, the lse3, the wait for the edge from the warp
  above (``noedge``);
- K3: the copies of the log attention, the ballot and store of the choice
  bits (``noballot``), the backtrack (``nobt``).

``--baseline`` names the ``csrc`` directory of an earlier tree (its
``ctc_band_dp.cu`` and ``mas_width1.cu``), timed beside, in the same
call, as ``base``. Needs a card and nvcc; raises without them.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from radmmm_torch.losses import ctc_kernel
from radmmm_torch.losses.ctc import _ctc_setup
from radmmm_torch.ops import alignment
from radmmm_torch.utils import cuda_build
from radmmm_torch.utils.device import card_line

OUT = cuda_build.BUILD_DIR.parent / "dp_row_costs"
B, T_MEL, T_TEXT = 8, 512, 96

# (kernel, variant) -> (source, [(text, replacement), ...])
CUTS = {
    ("alpha", "nofetch"): ("ctc_band_dp", [(
        "          cp_async4(ring + (size_t)(r % R) * S + st[k],\n"
        "                    e + (size_t)r * S + st[k]);", "          ;")]),
    ("alpha", "nolse"): ("ctc_band_dp", [(
        "a[k] = s <= top ? lse3(cur[s], p1, p2) + em[k] : kNeg;",
        "a[k] = s <= top ? fmaxf(fmaxf(cur[s], p1), p2) + em[k] : kNeg;")]),
    ("beta", "nofetch"): ("ctc_band_dp", [(
        "              copy4(dst + 4u * (unsigned)(u * S + 32 * k),\n"
        "                    src + (size_t)(n_dp - r) * S + 32 * k);",
        "              ;")]),
    ("beta", "nolse"): ("ctc_band_dp", [(
        "const float beta = lse3(q[k], n1, n2 + skip(s0 + 32 * k));",
        "const float beta = fmaxf(fmaxf(q[k], n1), n2 + skip(s0 + 32 * k));")]),
    ("beta", "noedge"): ("ctc_band_dp", [(
        "          edge_wait2(rd, j - 1, e0, e1);", "          e1 = -e0;")]),
    ("mas", "nofetch"): ("mas_width1", [(
        "                copy4(dst + 4u * (unsigned)(u * Tt + 32 * k),\n"
        "                      src + (size_t)(i0 + u) * Tt + 32 * k);",
        "                ;")]),
    ("mas", "noballot"): ("mas_width1", [(
        "        const unsigned int word = __ballot_sync(0xffffffffu, diag);\n"
        "        if (keep[k]) brow[k] = word;",
        "        if (keep[k] && diag && v[k] == 12345.f) brow[k] = 1u;")]),
    ("mas", "nobt"): ("mas_width1", [(
        "  if (threadIdx.x == 0 && live) {\n    // slot d",
        "  if (threadIdx.x == 0 && live && Tm < 0) {\n    // slot d")]),
}


def _sources(baseline):
    """(name, source name, text, include dir) of every copy to build."""
    csrc = cuda_build.CSRC
    out = []
    for src in ("ctc_band_dp", "mas_width1"):
        out.append((f"{src}.full", src, (csrc / f"{src}.cu").read_text(),
                    csrc))
        if baseline is not None:
            out.append((f"{src}.base", src,
                        (Path(baseline) / f"{src}.cu").read_text(),
                        Path(baseline)))
    for (kernel, cut), (src, subs) in CUTS.items():
        text = (csrc / f"{src}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{kernel} {cut}: the cut's text is not in "
                                   f"csrc/{src}.cu any more")
            text = text.replace(old, new)
        out.append((f"{src}.{kernel}_{cut}", src, text, csrc))
    return out


def build(baseline=None) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for name, _, text, inc in _sources(baseline):
        path = OUT / f"{name}.cu"
        path.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(inc), "-o",
             str(OUT / f"lib{name}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed:\n{err}")
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for fn in ("ctc_alpha_launch", "ctc_beta_launch",
                   "mas_width1_launch"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
                getattr(lib, fn).restype = ci
        libs[name] = lib
    return libs


def _ms(fn, reps=50) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="csrc directory of an earlier tree, timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dp_row_costs: no CUDA device")
    print(card_line(), flush=True)
    libs = build(args.baseline)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    tl = torch.full((B,), T_TEXT, dtype=torch.int32, device=dev)
    logits = torch.randn((B, T_MEL, T_TEXT), generator=g, device=dev) * 2
    _, emit, _ = _ctc_setup(logits, tl, -1.0)
    a = torch.softmax(torch.randn((B, T_MEL, T_TEXT), generator=g,
                                  device=dev) * 3, dim=-1)
    la = alignment._log_attention(a, tl).contiguous()
    S = emit.shape[2]
    band = torch.empty((T_MEL, B, S), device=dev)
    hard = torch.empty_like(la)
    rows = []
    for name, lib in libs.items():
        src, variant = name.split(".")
        kernels = ([variant.split("_")[0]] if "_" in variant else
                   (["alpha", "beta"] if src == "ctc_band_dp" else ["mas"]))
        for kernel in kernels:
            times = {}
            for ml_v in (T_MEL, T_MEL // 2):
                ml = torch.full((B,), ml_v, dtype=torch.int32, device=dev)
                if kernel == "mas":
                    def run():
                        return lib.mas_width1_launch(
                            la.data_ptr(), tl.data_ptr(), ml.data_ptr(),
                            hard.data_ptr(), B, T_MEL, T_TEXT, stream)
                else:
                    fn = getattr(lib, f"ctc_{kernel}_launch")

                    def run():
                        return fn(emit.data_ptr(), tl.data_ptr(),
                                  ml.data_ptr(), band.data_ptr(), B, T_MEL,
                                  S, stream)
                if run() != 0:
                    raise RuntimeError(f"{name} {kernel}: launch failed")
                torch.cuda.synchronize()
                if variant in ("full", "base") and ml_v == T_MEL:
                    if kernel == "mas":
                        ok = torch.equal(hard, alignment.mas_width1_reference(
                            la, tl, ml))
                    else:
                        ref = getattr(ctc_kernel,
                                      f"ctc_{kernel}_reference")(emit, tl, ml)
                        floor = ref < -1e29
                        ok = bool(torch.equal(band < -1e29, floor)) and bool(
                            ((band - ref).abs()[~floor]
                             <= 1e-5 + 1e-5 * ref.abs()[~floor]).all())
                    if not ok:
                        raise RuntimeError(f"{name} {kernel} disagrees with "
                                           "its twin")
                times[ml_v] = _ms(run)
            per_row = (times[T_MEL] - times[T_MEL // 2]) / (T_MEL // 2) * 1e3
            rows.append((kernel, variant, times[T_MEL], per_row))
    for kernel, variant, ms, per_row in sorted(rows):
        variant = variant.split("_", 1)[-1]
        print(f"{kernel:5s} {variant:9s} {ms:.4f} ms at mel_len {T_MEL}, "
              f"{per_row:.4f} us a row", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
