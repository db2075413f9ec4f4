"""A training cell's ``attempted`` and ``failed``: counted over the
window's first ``failure_horizon_epochs`` epochs, so that two programs
that diverge at the same step read the same share however many epochs
their windows hold (``drivers/train.window_failures``)."""

from __future__ import annotations

import json
import math

import pytest

import _small
from harness import load_json

train = _small.run.load_module(_small.BENCH_DIR / "drivers" / "train.py",
                               "bench_driver_train_for_failure_count")
NAN = math.nan
STEPS = 20


def losses(epochs: int, diverge_at: int | None = None) -> list:
    """A window's train losses: finite until window epoch ``diverge_at``
    (counted from 0), NaN from it on, as a loop that does not restart."""
    return [NAN if diverge_at is not None and e >= diverge_at else 10.0 - 0.1 * e
            for e in range(epochs)]


@pytest.mark.parametrize("epochs, horizon", [(8, 7), (51, 40), (3, 7)])
def test_a_finite_window_fails_nothing(epochs, horizon):
    assert train.window_failures(losses(epochs), STEPS, horizon) == \
        (min(epochs, horizon) * STEPS, 0)


@pytest.mark.parametrize("epochs", [8, 10])
def test_the_same_divergence_reads_alike_in_a_longer_window(epochs):
    # the parent's 8 window epochs against a faster program's 10
    assert train.window_failures(losses(epochs, 4), STEPS, 7) == (7 * STEPS, 3 * STEPS)


def test_an_earlier_divergence_fails_more():
    _, later = train.window_failures(losses(8, 4), STEPS, 7)
    _, earlier = train.window_failures(losses(10, 3), STEPS, 7)
    assert earlier == later + STEPS


def test_a_divergence_past_the_horizon_shows_only_in_the_window_count():
    window = losses(10, 8)
    assert train.window_failures(window, STEPS, 7) == (7 * STEPS, 0)
    assert train.nonfinite_epochs(window) == 2
    assert train.nonfinite_epochs([NAN, math.inf, -math.inf, 1.0]) == 3


def test_a_window_shorter_than_the_horizon_counts_what_it_has():
    assert train.window_failures(losses(5, 2), STEPS, 7) == (5 * STEPS, 3 * STEPS)
    assert train.window_failures([], STEPS, 7) == (0, 0)


@pytest.mark.parametrize("cell", [{}, {"failure_horizon_epochs": 0},
                                  {"failure_horizon_epochs": -3},
                                  {"failure_horizon_epochs": 7.0},
                                  {"failure_horizon_epochs": "7"},
                                  {"failure_horizon_epochs": True},
                                  {"failure_horizon_epochs": None}])
def test_a_missing_or_non_positive_horizon_raises(cell):
    with pytest.raises(ValueError, match="failure_horizon_epochs"):
        train.failure_horizon(cell)


HORIZONS = {"train.word128": 40, "train.char1024": 40, "train.densenet256": 7}


@pytest.mark.parametrize("workload", sorted(HORIZONS))
def test_each_training_workload_carries_its_horizon(workload):
    bench = load_json(_small.BENCH_DIR.parent / "BENCHMARK.json")
    assert workload in {w["name"] for w in bench["workloads"]}
    cell = load_json(_small.BENCH_DIR / "workloads" / f"{workload}.json")
    assert train.failure_horizon(cell) == HORIZONS[workload]


def test_every_training_workload_carries_a_horizon():
    bench = load_json(_small.BENCH_DIR.parent / "BENCHMARK.json")
    cells = [load_json(_small.BENCH_DIR / "workloads" / f"{w['name']}.json")
             for w in bench["workloads"]]
    training = [c for c in cells if c["driver"].startswith("train")]
    assert len(training) >= len(HORIZONS)
    assert all(train.failure_horizon(c) >= 1 for c in training)


def test_a_run_counts_its_horizon_and_reports_its_window():
    line, compared, readings = _small.execute("train.word128", seconds=2.0)
    horizon = HORIZONS["train.word128"]
    steps = readings["steps_per_epoch"]
    assert (line["attempted"], line["failed"]) == train.window_failures(
        readings["train_losses"], steps, horizon)
    assert line["attempted"] == min(readings["window_epochs"], horizon) * steps > 0
    side = _small.run.side_numbers(readings, compared)
    assert side["window_epochs"] == readings["window_epochs"] == len(readings["train_losses"])
    assert side["nonfinite_epochs"] == train.nonfinite_epochs(readings["train_losses"])
    assert not set(side) & set(compared)
    json.dumps(side)


def test_a_run_without_a_horizon_stops_before_set_up():
    bench, entry, cell, config = _small.cell("train.word128")
    del cell["failure_horizon_epochs"]
    with pytest.raises(ValueError, match="failure_horizon_epochs"):
        _small.run.execute(bench, entry, cell, config, "train.word128", 2 ** 31 + 11, 1.0,
                           False, "cpu")
