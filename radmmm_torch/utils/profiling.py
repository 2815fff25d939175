"""A torch.profiler window over a run of training steps."""
from __future__ import annotations

import os
import time
from typing import Optional

import torch

from radmmm_torch.utils.graphs import no_capture


def union_length(spans) -> float:
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


class StepProfiler:
    """Profiles steps ``start_step`` to ``start_step + n_steps - 1`` (the
    step numbers the caller passes, counted from 0) into a Chrome trace
    ``trace.json`` under ``directory``, and records the window's wall
    time, the device's busy time (the union of its kernels', copies' and
    sets' intervals), their summed time and the kernels that took most of
    it. Off when ``directory`` is None."""

    def __init__(self, directory: Optional[str], start_step: int,
                 n_steps: int, device: torch.device, top: int = 12):
        self.directory, self.start_step = directory, start_step
        self.n_steps, self.device, self.top = n_steps, device, top
        self._prof = None
        self._t0 = 0.0
        self.stats: dict = {}

    def before(self, step: int) -> None:
        if self.directory and step == self.start_step:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            # a loader's thread may be capturing its featurize graph
            with no_capture():
                self._prof.start()
            self._t0 = time.perf_counter()

    def after(self, step: int) -> None:
        if (self._prof is not None
                and step + 1 == self.start_step + self.n_steps):
            self._finish()

    def stop(self) -> None:
        """Stop a window the run left open, recording nothing."""
        if self._prof is not None:
            with no_capture():
                self._prof.stop()
            self._prof = None

    def _finish(self) -> None:
        from torch.autograd import DeviceType
        with no_capture():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - self._t0
            prof, self._prof = self._prof, None
            prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory, "trace.json")
        prof.export_chrome_trace(path)
        # the device's own activity: kernels, copies and sets, without the
        # user annotations (an optimizer's step range) that span them
        def on_device(e):
            return (e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False))

        kernels = sorted(((e.key, e.device_time_total / 1e3)
                          for e in prof.key_averages() if on_device(e)),
                         key=lambda kv: -kv[1])
        # busy: the union of the activity's intervals, since kernels can
        # overlap on the card
        busy = union_length((e.time_range.start, e.time_range.end)
                            for e in prof.events() if on_device(e)) / 1e6
        self.stats = dict(profile_wall_s=wall, profile_busy_s=busy,
                          profile_kernel_s=sum(ms for _, ms in kernels) / 1e3,
                          profile_steps=self.n_steps,
                          profile_top_ms=kernels[:self.top])
        print(f"profiler trace in {path}: {self.n_steps} steps, "
              f"wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
              f"(kernel time summed {self.stats['profile_kernel_s'] * 1e3:.1f}"
              " ms)")
