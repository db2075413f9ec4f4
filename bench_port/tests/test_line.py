"""The result line's shape, and the harness's refusal without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import _small

LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def test_line_of_a_training_cell():
    line, compared, _ = _small.execute("train.word128")
    assert list(line) == LINE_KEYS  # the compared numbers come last
    assert isinstance(line["correct"], bool) and line["attempted"] > 0
    assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line["check"]) == list(compared) == ["grad", "change"]
    json.dumps(line)


def test_no_card_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run([sys.executable, str(_small.BENCH_DIR / "run.py"), "--workload",
                           "train.word128", "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=_small.BENCH_DIR.parent,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
