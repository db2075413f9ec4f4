"""Profiling (mopoe_mimic_tpu/utils/profiling.py): the program's spans and
counters, a ``torch.profiler`` trace written as a Chrome trace, and the
card's memory in use.

``span(name, **attrs)`` times a block on the host's clock
(``time.perf_counter_ns``) and keeps it, with its attributes, its own id,
its parent's (the span open around it on the same thread) and the epoch
(given, or its parent's), in a bounded ring that ``spans()`` reads: the
oldest fall out past ``RING_SPANS``. Nothing writes the ring anywhere. A
span never waits for the card or reads a device value. While a
``torch.profiler`` runs, a span also enters ``record_function(name)``, so
that it lands on the profiler's host timeline between the card's kernels;
otherwise it costs a flag check, two clock reads and an append.

``COUNTERS`` holds plain counts that the program adds to where it opens
the matching spans (``count``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Deque, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from mopoe_mimic_tpu_torch.utils.logger import log

RING_SPANS = 65_536

_RING: Deque["Span"] = collections.deque(maxlen=RING_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
COUNTERS: Dict[str, int] = {}


class Span:
    """One timed block: ``name``, ``id``, ``parent`` (an id or None),
    ``epoch`` (or None), ``start_ns`` and ``end_ns`` on
    ``time.perf_counter_ns``, and ``attrs``, which the block may add to
    while it runs."""

    __slots__ = ("name", "id", "parent", "epoch", "start_ns", "end_ns", "attrs", "_record")

    def __init__(self, name: str, parent: Optional[int], epoch: Optional[int],
                 attrs: Dict[str, Any]):
        self.name, self.parent, self.epoch, self.attrs = name, parent, epoch, attrs
        self.id = 0
        self.start_ns = self.end_ns = 0
        self._record = None

    def __enter__(self) -> "Span":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        if stack:
            if self.parent is None:
                self.parent = stack[-1].id
            if self.epoch is None:
                self.epoch = stack[-1].epoch
        self.id = next(_IDS)
        stack.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._record is not None:
            self._record.__exit__(*exc)
            self._record = None
        _LOCAL.stack.pop()
        _RING.append(self)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def span(name: str, parent: Optional[int] = None, epoch: Optional[int] = None,
         **attrs) -> Span:
    """A context manager that times its block as the span ``name``.
    ``parent`` and ``epoch`` default to those of the span open around it on
    this thread; work handed to another thread passes them."""
    return Span(name, parent, epoch, attrs)


def spans() -> List[Span]:
    """The ring's spans, oldest first by the time they ended."""
    return list(_RING)


def count(name: str, n: int = 1) -> None:
    COUNTERS[name] = COUNTERS.get(name, 0) + n


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
