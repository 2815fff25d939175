"""What every cell of the benchmark shares: the cell's files, the device
checks, the caches inside the checkout, the measured window, the traced
window and its reduction, the check that JAX stayed out, and the result
line.

A cell is ``workloads/<name>.json`` (its configuration, its traffic kind
and the kind's parameters, its limits); its configuration is
``configs/<config>.json``; its traffic kind is ``traffic/<kind>.py``; a
per-layer metric is read by ``metrics/<name>.py`` (or by the file of the
part of its name before the first dot); a kernel's names in the trace and
its bound are ``kernels/<kernel>.json``. The harness finds each by name,
so a new cell, configuration, traffic kind, metric or kernel is a new
file.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List

ROOT = Path(__file__).resolve().parent          # portbench/
CHECKOUT = ROOT.parent
# module names that must not be loaded in the process that prints the
# result, compared by the whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "radmmm_tpu")
# runtime calls that queue work on the card, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch",
                     "cudaMemcpy", "cudaMemset")
# seconds of the measured window that a traced run profiles
TRACE_SECONDS = 2.0


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def workload(name: str) -> Dict[str, Any]:
    spec = load_json(ROOT / "workloads" / f"{name}.json")
    spec["name"] = name
    spec["config_spec"] = load_json(ROOT / "configs"
                                    / f"{spec['config']}.json")
    return spec


def load_module(path: Path, name: str):
    """A module of the benchmark from its file (names may hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def traffic_kind(kind: str):
    return load_module(ROOT / "traffic" / f"{kind}.py",
                       f"portbench_traffic_{kind}")


def metric_reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    if not path.exists():
        path = ROOT / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path, "portbench_metric_" + name.replace(".", "_"))


def kernel_spec(name: str) -> Dict[str, Any]:
    return load_json(ROOT / "kernels" / f"{name}.json")


def benchmark_entry(name: str) -> Dict[str, List[Dict[str, Any]]]:
    """The cell's end-to-end and per-layer metrics from BENCHMARK.json."""
    bench = load_json(CHECKOUT / "BENCHMARK.json")

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {"end_to_end": [m for m in bench["end_to_end"] if mine(m)],
            "per_layer": [m for m in bench["per_layer"] if mine(m)]}


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds."""
    base = CHECKOUT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)
    # a library that would load JAX by itself is kept from it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def require_cards(n: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device is available")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"portbench: the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} are visible")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def tf32_off() -> None:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation, over all
    values."""
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Marks:
    """Seconds since ``t0`` at each named point of a run's set-up, printed
    to standard error as they pass."""

    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self, what: str) -> None:
        print(f"setup {time.perf_counter() - self.t0:.2f} s: {what}",
              file=sys.stderr, flush=True)


class Window:
    """The measured window: ``deadline`` seconds of host time from
    ``open``; ``close`` synchronises the device and returns the window's
    seconds, start to the end of the last work."""

    def __init__(self, seconds: float, sync: Callable[[], None]):
        self.seconds = seconds
        self.sync = sync
        self.t0 = self.deadline = None

    def open(self) -> float:
        self.sync()
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + self.seconds
        return self.t0

    def running(self) -> bool:
        return time.perf_counter() < self.deadline

    def close(self) -> float:
        self.sync()
        return time.perf_counter() - self.t0


def trace_summary(prof, wall_s: float) -> Dict[str, Any]:
    """The reduction of a torch.profiler trace: every device interval
    (kernels, copies, fills) with its name, the union of them (the busy
    time), the host's launch calls by name, and the host's annotated
    spans, each on the profiler's clock in microseconds."""
    from torch.autograd import DeviceType
    dev, host_calls, spans = [], {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False):
                continue
            dev.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type == DeviceType.CPU:
            if e.name.startswith(HOST_LAUNCH_CALLS):
                host_calls[e.name] = host_calls.get(e.name, 0) + 1
            elif e.name.startswith("portbench."):
                spans.append((e.name, e.time_range.start, e.time_range.end))
    busy_us = union_length((a, b) for _, a, b in dev)
    return {"device": dev, "busy_s": busy_us / 1e6, "window_s": wall_s,
            "host_calls": host_calls, "spans": spans}


def union_length(spans) -> float:
    """The length of the union of (start, end) intervals (a frozen copy
    of the port's ``utils/profiling.union_length``)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def breakdown(summary: Dict[str, Any], top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the longest idle
    gaps of the device named by the host span that held them."""
    by_name: Dict[str, float] = {}
    for name, a, b in summary["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], None
    for name, a, b in sorted(summary["device"], key=lambda x: x[1]):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    named: Dict[str, float] = {}
    for a, b in gaps:
        held = [n for n, s, e in summary["spans"] if s <= a and e >= b]
        key = "idle in " + (held[-1] if held else "no span")
        named[key] = max(named.get(key, 0.0), (b - a) / 1e6)
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def device_info(n_cards: int, peak_bytes: int) -> Dict[str, Any]:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n_cards, "memory_peak_bytes": int(peak_bytes)}


def checks_lines(checks: List[Dict[str, Any]]) -> List[str]:
    return [f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
            f"({'ok' if c['ok'] else 'FAILED'})" for c in checks]


def emit(result: Dict[str, Any], checks: List[Dict[str, Any]]) -> None:
    """The comparisons as the last lines of standard error, then the
    result as the last line of standard output, the comparisons under its
    last key."""
    for line in checks_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    print(json.dumps(result), flush=True)


def judged(name: str, value: float, limit: float) -> Dict[str, Any]:
    """One number compared with its limit (the value must not exceed
    it; a value that is not a number fails)."""
    ok = isinstance(value, (int, float)) and math.isfinite(value) \
        and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}


def result_of(cell: Dict[str, Any], out: Dict[str, Any],
              trace: bool) -> Dict[str, Any]:
    """The result line's object: with ``trace`` the cell's per-layer
    metrics (each reader that finds nothing to read leaves its metric
    out), otherwise its end-to-end metrics."""
    entry = benchmark_entry(cell["name"])
    metrics = {}
    if trace:
        for m in entry["per_layer"]:
            value = metric_reader(m["name"]).read(m["name"], out["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in entry["end_to_end"]:
            if m["name"] in out["e2e"]:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = device_info(int(cell["chips"]), out["peak_bytes"])
    result = {"correct": all(c["ok"] for c in out["checks"]),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace:
        summary = out["ctx"]["summary"]
        device.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = breakdown(summary)
    return result


def profiled(fn: Callable[[], Any], seconds: float,
             sync: Callable[[], None]):
    """``fn()`` under torch.profiler (host and device), for a window of
    ``seconds`` that ``fn`` keeps itself; returns (fn's result, the trace
    summary)."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
    return res, trace_summary(prof, wall)


def kernel_time_s(summary: Dict[str, Any], names: List[str]) -> float:
    """Device seconds of the trace's kernels whose name holds one of
    ``names``."""
    return sum((b - a) / 1e6 for n, a, b in summary["device"]
               if any(k in n for k in names))
