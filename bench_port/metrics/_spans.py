"""What the readers of the program's spans share: the ring of the span
recorder in the process that ran the cell
(``mopoe_mimic_tpu_torch.utils.profiling``), and the profiled epoch's spans
placed on the profiler's clock beside the device's busy intervals.

The clock: a span is stamped with ``time.perf_counter_ns``, the profile in
microseconds from its own start. The profiled epoch's train pass stamps
each graph replay just before ``graph.replay()``, and the profile holds
each ``cudaGraphLaunch``'s host start (``graph_launches``): the first
``steps_per_epoch`` launches are that pass's replays, one for one. The
median of launch less stamp is the offset that maps a span onto the
profile; the spread is the distance between the differences' quartiles.
(The launch follows its stamp by the replay's prologue, which the
profiler slows to ~0.1 ms and which now and then takes 0.05-0.2 ms more:
spans land that much late, and a few differences lie far from the rest.)

The device's backlog: from a pass's first replay to the last device
event that ends inside the pass's read (``scan.read_means``), the card
works through work already queued, and its idle stretches there are the
gaps between the graph's own kernels, not the host's. They are kept apart
from the loop's idle time.

A program without the recorder, or a run without a profile, gives None.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

Interval = Tuple[float, float]

# device idle in these is not the loop's own host work
OUTSIDE_LOOP = ("loop.epoch", "loop.train_pass", "loop.test_pass", "scan.replays")


def program_spans() -> Optional[list]:
    """The process's spans, or None where the program keeps none."""
    try:
        from mopoe_mimic_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def traced_spans(readings: dict) -> Optional[list]:
    """The spans of a run that was profiled, or None."""
    if readings.get("profile") is None:
        return None
    return program_spans() or None


def seconds_of(readings: dict, name: str) -> Optional[float]:
    """The summed seconds of the run's spans called ``name``, or None
    where there are none."""
    spans = traced_spans(readings)
    found = [s for s in spans or () if s.name == name]
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9


def alignment(stamps_ns: Sequence[int], launches_us: Sequence[float]
              ) -> Optional[Tuple[float, float]]:
    """(offset, spread) in µs (module docstring) from each launch and the
    stamp before its replay, pair by pair."""
    if len(stamps_ns) < 2 or len(launches_us) < len(stamps_ns):
        return None
    diffs = [t - s / 1e3 for s, t in zip(stamps_ns, launches_us)]
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    return statistics.median(diffs), q3 - q1


def merge(intervals) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def idle_within(events, lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] in which no device event ran."""
    out, at = [], lo
    for s, e in merge((s, e) for _, s, e in events):
        if e <= at:
            continue
        if s >= hi:
            break
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def subtract(a, holes) -> List[Interval]:
    """``a`` less ``holes``."""
    out, holes = [], merge(holes)
    for s, e in merge(a):
        for hs, he in holes:
            if he <= s or hs >= e:
                continue
            if hs > s:
                out.append((s, hs))
            s = max(s, he)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def overlap(a: Sequence[Interval], b) -> float:
    """The length of the intersection of two sets of intervals."""
    a, b = merge(a), merge(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def profiled_epoch(readings: dict) -> Optional[dict]:
    """The profiled epoch (the run's last) on the profiler's clock:
    ``spans`` as (span, start µs, end µs), ``idle`` (the device's idle
    stretches from the epoch's start to its guard read, in which the
    profiler stops), ``backlog`` (each pass's, module docstring),
    ``offset_us`` and ``spread_us``; or None."""
    spans = traced_spans(readings)
    prof = readings.get("profile")
    if not spans or not prof or not prof["device_events"]:
        return None
    passes = [s for s in spans if s.name == "loop.train_pass"]
    if not passes:
        return None
    last = passes[-1]
    replays = [s for s in spans if s.name == "scan.replays" and s.parent == last.id]
    steps = readings["steps_per_epoch"]
    if len(replays) != 1 or len(replays[0].attrs.get("stamps", ())) != steps:
        return None
    aligned = alignment(replays[0].attrs["stamps"], prof["graph_launches"][:steps])
    if aligned is None:
        return None
    offset, spread = aligned
    epoch = [s for s in spans if s.epoch == last.epoch and s.end_ns >= last.start_ns]
    placed = [(s, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset) for s in epoch]
    whole = [p for p in placed if p[0].name == "loop.epoch"]
    guard = [p for p in placed if p[0].name == "loop.preemption_read"]
    if not whole or not guard:
        return None
    lo, hi = whole[-1][1], guard[-1][1]
    ends = sorted(e for _, _, e in prof["device_events"])
    backlog = []
    for sp, start, _ in placed:
        if sp.name != "scan.replays":
            continue
        read = [e for r, _, e in placed if r.name == "scan.read_means" and r.parent == sp.parent]
        last = bisect.bisect_right(ends, read[0]) - 1 if read else -1
        done = ends[last] if last >= 0 else start
        if done > start:
            backlog.append((start, done))
    return {"spans": placed, "idle": idle_within(prof["device_events"], lo, hi),
            "backlog": backlog, "offset_us": offset, "spread_us": spread}


def loop_idle_us(epoch: dict) -> float:
    """The profiled epoch's idle µs inside the loop's own spans (all but
    ``OUTSIDE_LOOP``) and outside the device's backlog."""
    loop = [(s, e) for sp, s, e in epoch["spans"] if sp.name not in OUTSIDE_LOOP]
    return overlap(epoch["idle"], subtract(loop, epoch["backlog"]))


def idle_by_span(epoch: dict) -> Dict[str, float]:
    """The profiled epoch's idle µs by the innermost span around them
    (the shortest that holds them), "backlog" within the device's backlog,
    "none" where no span holds them."""
    placed = sorted(epoch["spans"], key=lambda p: p[2] - p[1])
    cuts = sorted({t for _, s, e in placed for t in (s, e)}
                  | {t for iv in epoch["backlog"] for t in iv})
    out: Dict[str, float] = {}
    for lo, hi in epoch["idle"]:
        inner = cuts[bisect.bisect_right(cuts, lo):bisect.bisect_left(cuts, hi)]
        for a, b in zip([lo, *inner], [*inner, hi]):
            mid = (a + b) / 2
            if any(s <= mid <= e for s, e in epoch["backlog"]):
                name = "backlog"
            else:
                name = next((sp.name for sp, s, e in placed if s <= mid <= e), "none")
            out[name] = out.get(name, 0.0) + (b - a)
    return out
