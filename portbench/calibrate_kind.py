"""``calibrate.py``'s readings for a cell whose traffic kind brings its own
controls, ``controls(cell, seed, dev, faults)`` -> {reading: numbers}
(``calibrate.py`` dispatches the kinds ``train`` and ``serve`` alone):

    python3 -m portbench.calibrate_kind --workload radtts.train.f0cache \
        --seeds 12 --control 3 --faults half_batch [--first-seed 1000]

One JSON line a reading, then a summary line: each number's largest
program reading and smallest control or fault reading. Runs on the card
at the cell's own size; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import sys
import time

import torch

from portbench import harness
from portbench.calibrate import _line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate_kind")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    harness.fixed_caches()
    cell = harness.workload(args.workload)
    harness.require_cards(int(cell["chips"]))
    harness.tf32_off()
    kind = harness.traffic_kind(cell["traffic"]["kind"])
    dev = torch.device("cuda")
    faults = [f for f in args.faults.split(",") if f]
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        out = kind.run(cell, seed, args.seconds, False, t0=t0)
        _line(what="program", seed=seed, numbers=out["numbers"],
              seconds=time.perf_counter() - t0, e2e=out["e2e"],
              peak_bytes=out["peak_bytes"])
        for k, v in out["numbers"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        if i < args.control:
            for what, nums in kind.controls(cell, seed, dev, faults).items():
                _line(what=what, seed=seed, numbers=nums)
                got = upper.setdefault(what, {})
                for k, v in nums.items():
                    got[k] = min(got.get(k, float("inf")), v)
            gc.collect()
            torch.cuda.empty_cache()
    _line(what="summary", lower=lower, upper=upper,
          card=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
