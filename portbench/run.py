"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload radmmm.train.b8 --seed 7 \
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the cards the cell asks
for. With ``--trace 0`` the result carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics read from a profiled window.
Every run checks what its timed path produced against the plain
reference under ``portbench/reference`` and prints each number compared
beside its limit, as the last lines of standard error and under the last
key of the result.
"""
from __future__ import annotations

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    harness.fixed_caches()
    cell = harness.workload(args.workload)
    harness.require_cards(int(cell["chips"]))
    harness.tf32_off()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    out = kind.run(cell, args.seed, args.seconds, bool(args.trace),
                   t0=PROCESS_T0)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    harness.emit(harness.result_of(cell, out, bool(args.trace)),
                 out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
