"""The check that decides ``correct``: the control reads worse than the
program at a size the CPU holds, and the control and each fault a cell can
have, planted under a run that skips the look for a card, come out not
correct by the cell's committed limits."""

from __future__ import annotations

import json

import pytest

import _small
import calibrate


def test_training_control_reads_worse_than_the_program(capsys):
    orig = _small.run.cell_files
    _small.run.cell_files = _small.cell
    try:
        calibrate.main(["--workload", "train.word128", "--control-seeds", "5",
                        "--device", "cpu"])
    finally:
        _small.run.cell_files = orig
    rows = {r["kind"]: r for r in map(json.loads, capsys.readouterr().out.splitlines())
            if "kind" in r}
    for number in ("loss", "grad", "change"):
        assert rows["control"][number] > 3 * rows["program"][number]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "control"])
@pytest.mark.parametrize("workload", ["train.word128", "train.char1024"])
def test_training_faults_are_not_correct(workload, fault):
    line, compared, readings = _small.execute(workload, fault=fault)
    assert line["correct"] is False
    assert any(v > lim for v, lim in compared.values())
    if fault == "unchanged":
        assert readings["check"]["change"] > 0.9  # the median leaf has not moved
