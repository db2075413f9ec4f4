"""The method cells of tests/test_training_matrix.py (moe/char, jsd/word,
poe/char) through the port's training CLI (``main`` → ``Experiment`` →
``run_epochs``) on the CPU: 2 epochs × 2 steps at the JAX cells' widths
(batch 8, class_dim 4, DIM 2, 128 px, vocab 50, float32, seed 3). The
port's heavy evaluations are not ported, so the cells run without them.
Each cell finishes finite, runs both epochs and lands its row in
experiments_dataframe.csv.
"""

import csv

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu_torch import main as port_main

CELLS = {"moe_char": ("moe", "char"), "jsd_word": ("jsd", "word"), "poe_char": ("poe", "char")}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models (as
    tests/test_torch_port_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_method_cell_through_main(tmp_path, cell):
    method, text = CELLS[cell]
    argv = ["--method", method, "--dataset", "testing", "--batch_size", "8", "--class_dim", "4",
            "--DIM_img", "2", "--DIM_text", "2", "--img_size", "128", "--text_encoding", text,
            "--vocab_size", "50", "--compute_dtype", "float32", "--end_epoch", "2",
            "--steps_per_training_epoch", "2", "--seed", "3", "--dir_experiment", str(tmp_path),
            "--eval_lr", "false", "--calc_nll", "false", "--use_clf", "false"]
    result = port_main.main(argv, device="cpu")
    assert result["epochs_run"] == 2 and [h["epoch"] for h in result["history"]] == [0, 1]
    assert all(np.isfinite(h["train_loss"]) for h in result["history"])
    cfg = result["state"].model.cfg
    assert (cfg.method, cfg.text_encoding) == (method, text)
    assert cfg.len_sequence == (1024 if text == "char" else 128)
    with open(tmp_path / "experiments_dataframe.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["method"] == method
    assert rows[0]["text_encoding"] == text and float(rows[0]["total_epochs"]) == 1
