"""What the per-layer readers share: the profiled epoch's train pass.

The profiled epoch replays the train step's graph once a step, then the
test pass replays its own graph: the device events that start before the
host's first launch past the train pass's steps are the train pass's."""

from __future__ import annotations

from typing import Optional, Tuple

import harness


def train_pass(readings: dict) -> Optional[Tuple[list, float, int]]:
    """(device events, the cut in the profiler's µs, steps) of the profiled
    epoch's train pass, or None where nothing was profiled."""
    prof = readings.get("profile")
    if prof is None or not prof["device_events"]:
        return None
    steps, launches = readings["steps_per_epoch"], prof["graph_launches"]
    if len(launches) < steps:
        return None
    cut = launches[steps] if len(launches) > steps else float("inf")
    return prof["device_events"], cut, steps


def ms_per_step(readings: dict, match) -> Optional[float]:
    part = train_pass(readings)
    if part is None:
        return None
    events, cut, steps = part
    seconds = harness.kernel_seconds(events, match, cut)
    return seconds / steps * 1e3 if seconds > 0 else None
