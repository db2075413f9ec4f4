"""A cell of the benchmark at a size the CPU holds: the cell's own files,
widths and batch cut down, driven through ``run.execute`` on the CPU."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402

SMALL = {"DIM_img": 8, "DIM_text": 8, "class_dim": 8, "batch_size": 8,
         "steps_per_training_epoch": 4}
SMALL_TRAFFIC = {"rows": 32, "test_rows": 8}
CELL_FILES = run.cell_files


def cell(workload: str):
    """The cell's files at the CPU's size."""
    bench, entry, cell, config = CELL_FILES(workload)
    config["config"].update(SMALL)
    cell["traffic"].update(SMALL_TRAFFIC)
    return bench, entry, cell, config


def execute(workload: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0, fault: str = ""):
    bench, entry, c, config = cell(workload)
    return run.execute(bench, entry, c, config, workload, seed, seconds, False, "cpu",
                       fault=fault)
