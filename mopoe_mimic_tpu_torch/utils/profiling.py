"""Profiling (mopoe_mimic_tpu/utils/profiling.py): a ``torch.profiler``
trace written as a Chrome trace, named regions on its timeline, a
samples/s step timer and the card's memory in use."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from mopoe_mimic_tpu_torch.utils.logger import log


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (the host, and the card where there is one) and
    write ``logdir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info(f"profiler trace written to {path}")


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Throughput meter: call tick(batch_size) once per step; read
    samples_per_sec over the tail window (the first ``warmup`` ticks, which
    build and capture, excluded)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._ticks = 0
        self._samples = 0
        self._t0: Optional[float] = None

    def tick(self, batch_size: int) -> None:
        self._ticks += 1
        if self._ticks == self.warmup:
            self._t0 = time.perf_counter()
        elif self._ticks > self.warmup:
            self._samples += batch_size

    @property
    def samples_per_sec(self) -> float:
        if self._t0 is None or self._samples == 0:
            return 0.0
        return self._samples / (time.perf_counter() - self._t0)


def device_memory_stats() -> dict:
    """Each card's memory in use by PyTorch's allocator and its capacity
    (the reference's nvidia-smi parse, mimic/utils/flags.py:131-138); empty
    without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
                            "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
    return out
