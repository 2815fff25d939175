"""Readings that set a cell's limits: the program against the plain
reference over many seeds (the lower readings), and the control (the
reference in the next lower precision, TF32, put in the program's place)
and the faults a cell can have, each against the reference on a few
seeds (the upper readings).

    python3 -m portbench.calibrate --workload radmmm.train.b8 \
        --seeds 12 --control 3 --seconds 1 [--first-seed 1000]

One JSON line a reading, then a summary line: each number's largest
program reading and smallest control or fault reading. Runs on the card
at the cell's own size; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import compare, harness


def _line(**kw):
    print(json.dumps(kw), flush=True)


def train_controls(cell, seed, dev, faults):
    kind = harness.traffic_kind("train")
    from portbench.reference import train as ref_train
    cs, p = cell["config_spec"], cell["traffic"]
    items = kind.make_items(p, cs, seed)
    hosts = kind.make_batches(p, cs, items)
    raws = [kind._raw(h) for h in hosts][:ref_train.COMPARED_STEPS]
    ds = kind.dropout_seed(seed)
    base = ref_train.run(cs, seed, raws, ds, dev)
    out = {}
    for what, kw in [("control_tf32", {"lower_precision": True})] + [
            (f, {"fault": f}) for f in faults]:
        gc.collect()
        torch.cuda.empty_cache()
        got = ref_train.run(cs, seed, raws, ds, dev, **kw)
        out[what] = compare.train_numbers(got, base)
    return out


def serve_controls(cell, seed, dev, faults):
    kind = harness.traffic_kind("serve")
    from portbench.reference import serve as ref_serve
    cs, p = cell["config_spec"], cell["traffic"]
    reqs = kind.make_requests(p, cs, seed)[:int(p["sample"])]
    ref = ref_serve.Reference(cs, seed, dev)
    fb = sorted(p["frame_buckets"])
    bucket = p["buckets"][0]
    base = [ref(r, bucket, fb) for r in reqs]
    low = [ref(r, bucket, fb, lower_precision=True) for r in reqs]
    return {"control_tf32": ref_serve.serve_numbers(low, base)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.calibrate")
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
    kind_name = cell["traffic"]["kind"]
    kind = harness.traffic_kind(kind_name)
    dev = torch.device("cuda")
    faults = [f for f in args.faults.split(",") if f]
    lower, upper = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        out = kind.run(cell, seed, args.seconds, False, t0=t0)
        nums = out["numbers"]
        _line(what="program", seed=seed, numbers=nums,
              seconds=time.perf_counter() - t0, e2e=out["e2e"])
        for k, v in nums.items():
            lower[k] = max(lower.get(k, 0.0), v)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        if i < args.control:
            ctl = (train_controls if kind_name == "train"
                   else serve_controls)(cell, seed, dev, faults)
            for what, nums in ctl.items():
                _line(what=what, seed=seed, numbers=nums)
                for k, v in nums.items():
                    upper.setdefault(what, {})
                    upper[what][k] = min(upper[what].get(k, float("inf")), v)
            gc.collect()
            torch.cuda.empty_cache()
    _line(what="summary", lower=lower, upper=upper,
          card=torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
