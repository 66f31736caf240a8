"""Tracing / profiling: phase timers + metrics registry + device traces.

Port of ``sba_tpu/utils/profiling.py``: `Timer` and `Metrics` as they
are; sba_tpu's `jax_trace` (a `jax.profiler` capture) becomes
`torch_trace`, a `torch.profiler` capture of the CPU and, when there is
a card, CUDA activity, written as a Chrome trace.

Capability parity with ref: src/util/timer.h:39 (`Timer` with
Start/Pause/Elapsed/PrintSeconds, used by every controller) — extended to
the structured form the reference lacks (SURVEY §5): a process-global
metrics dict, nested phase timers usable as context managers, and an
opt-in `jax.profiler` trace capture (the xplane counterpart of the
reference's gperftools PROFILING_ENABLED link flag).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class Timer:
    """Ref: util/timer.h:39 semantics (Start/Restart/Pause/Resume/
    Elapsed*)."""

    def __init__(self):
        self._start: Optional[float] = None
        self._paused_at: Optional[float] = None
        self._accum = 0.0

    def start(self):
        if self._start is None:
            self._start = time.perf_counter()
        return self

    def restart(self):
        self._start = time.perf_counter()
        self._accum = 0.0
        self._paused_at = None
        return self

    def pause(self):
        if self._start is not None and self._paused_at is None:
            self._paused_at = time.perf_counter()

    def resume(self):
        if self._paused_at is not None:
            self._accum -= time.perf_counter() - self._paused_at
            self._paused_at = None

    def elapsed_seconds(self) -> float:
        if self._start is None:
            return 0.0
        end = self._paused_at if self._paused_at is not None \
            else time.perf_counter()
        return end - self._start + self._accum

    def elapsed_minutes(self) -> float:
        return self.elapsed_seconds() / 60.0

    def print_seconds(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_seconds():.3f} [seconds]")

    def print_minutes(self, label: str = "Elapsed time"):
        print(f"{label}: {self.elapsed_minutes():.3f} [minutes]")


class Metrics:
    """Structured run metrics: phase wall times + counters + gauges."""

    def __init__(self):
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        self.phase_counts: Dict[str, int] = defaultdict(int)
        self.values: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phase_seconds[name] += time.perf_counter() - t0
            self.phase_counts[name] += 1

    def set(self, name: str, value: float):
        self.values[name] = float(value)

    def add(self, name: str, value: float = 1.0):
        self.values[name] = self.values.get(name, 0.0) + float(value)

    def as_dict(self) -> dict:
        return dict(
            phases={k: dict(seconds=self.phase_seconds[k],
                            count=self.phase_counts[k])
                    for k in self.phase_seconds},
            values=dict(self.values))

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2)

    def report(self) -> str:
        lines = []
        for k in sorted(self.phase_seconds):
            lines.append(f"  {k}: {self.phase_seconds[k]:.3f}s "
                         f"(x{self.phase_counts[k]})")
        for k in sorted(self.values):
            lines.append(f"  {k} = {self.values[k]:g}")
        return "\n".join(lines)


# Process-global registry (controllers record into this by default).
global_metrics = Metrics()


@contextlib.contextmanager
def torch_trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator:
    """Capture a `torch.profiler` trace of the block and write it to
    `<log_dir>/trace.json` (Chrome trace format; open in Perfetto or
    chrome://tracing). `cuda` adds the card's activity (default: when a
    card is present). Yields the profiler, whose `key_averages()` sums
    the device time per kernel."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
