"""What every driver of the benchmark shares: the cell's files found by
name, the card's description, the profiler's reduction to busy time, idle
gaps and time by kernel, the guard that ends a window of whole epochs,
and the seeds.

Imports nothing of the program under test.
"""

from __future__ import annotations

import json
import re
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def substream(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of a run's ``seed``."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


def card() -> Dict[str, str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        return {"power_limit_w": "not measured", "sm_max_clock_mhz": "not measured"}
    name, limit, clock = [x.strip() for x in proc.stdout.splitlines()[0].split(",")]
    return {"name": name, "power_limit_w": limit, "sm_max_clock_mhz": clock}


class WindowGuard:
    """The ``preemption`` object a window runs under: the loop reads
    ``requested`` once an epoch, right after the epoch's callbacks. Each
    read is stamped. The first read opens the window; once ``seconds`` have
    passed since it, a read starts the profiler when ``profile`` is given
    (and returns False, so that one more epoch runs under it) or closes the
    window (True). ``on_close`` runs just before a True is returned."""

    def __init__(self, seconds: float, profile=None, on_close: Callable[[], None] = None):
        self.seconds, self.profile, self.on_close = seconds, profile, on_close
        self.stamps: List[float] = []
        self.window_end: Optional[int] = None  # index of the read that closed the timing
        self.closed = False

    @property
    def requested(self) -> bool:
        now = time.perf_counter()
        self.stamps.append(now)
        if self.window_end is None and now - self.stamps[0] >= self.seconds:
            self.window_end = len(self.stamps) - 1
            if self.profile is not None:
                self.profile.start()
                return False
        if self.window_end is not None and not self.closed:
            if self.profile is not None and self.profile.running:
                self.profile.stop()
            self.closed = True
            if self.on_close is not None:
                self.on_close()
        return self.closed


def kernel_name(event_name: str) -> str:
    """The function's name in a profiler event's name: no namespace,
    template arguments or parameters."""
    name = event_name.replace("(anonymous namespace)::", "").removeprefix("void ")
    name = re.split(r"[<(]", name)[0]
    return name.split("::")[-1] or event_name


class Profile:
    """``torch.profiler`` over a stretch that ``start`` and ``stop`` mark,
    reduced to: the stretch's wall seconds, the device's busy seconds (the
    union of the kernel and copy intervals), the device seconds by kernel,
    the device events themselves, and the gaps in which the device idled,
    the ten longest named by the innermost host event around each."""

    def __init__(self):
        self.running = False
        self.result: Optional[dict] = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.running = True

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        self.running = False
        self.result = reduce_profile(self._prof.events(), wall)
        del self._prof


def reduce_profile(events, wall_s: float) -> dict:
    from torch.autograd import DeviceType

    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    merged: List[List[float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    longest = sorted(((start - end, end, start) for (_, end), (start, _)
                      in zip(merged, merged[1:])), reverse=True)[:10]
    gaps = []
    for length, end, start in longest:
        mid = (end + start) / 2
        around = [h for h in host if h.time_range.start <= mid <= h.time_range.end]
        name = (min(around, key=lambda h: h.time_range.end - h.time_range.start).name
                if around else "host (no op recorded)")
        gaps.append((name, length / 1e6))
    launches = sorted(h.time_range.start for h in host if h.name == "cudaGraphLaunch")
    return {"wall_s": wall_s, "busy_s": busy_us / 1e6,
            "by_name_s": {k: v / 1e6 for k, v in by_name.items()},
            "device_events": [(e.name, e.time_range.start, e.time_range.end) for e in dev],
            "graph_launches": launches, "gaps": gaps}


def breakdown(prof: dict) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps by what the host was doing."""
    ops: Dict[str, float] = {}
    for name, t in prof["by_name_s"].items():
        ops[kernel_name(name)] = ops.get(kernel_name(name), 0.0) + t
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, t] for n, t in top],
            "idle_gaps": [[n, t] for n, t in prof["gaps"]]}


def kernel_seconds(events, match: Callable[[str], bool], before: float = float("inf")) -> float:
    """Device seconds of the events whose kernel name ``match``es and that
    start before ``before`` (µs, the profiler's clock)."""
    return sum(e - s for n, s, e in events if s < before and match(kernel_name(n))) / 1e6
