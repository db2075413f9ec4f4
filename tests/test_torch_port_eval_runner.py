"""The eval round in the port's training loop (mopoe_mimic_tpu_torch/
evaluation/runner.py, train/loop.py), on the CPU, one intra-op thread.

* ``python -m mopoe_mimic_tpu_torch.main --config_path configs/flagship.json
  --dataset testing_structured`` at the flagship's widths with only depth
  flags (batch 8, 32 rows, 1 epoch of 2 steps, 1 test batch an eval, 1
  quick classifier epoch, 16 lr-eval samples) and ``--device cpu``: eval_lr,
  use_clf and calc_nll run, their metrics reach the CSV row, the
  classifiers' weights ``dir_clf``.
* An eval round leaves the state as it found it: parameters, buffers
  and the addresses of every tensor of the train state, the model's mode,
  the state's generator and the default one.
* A ``--load_run`` resume of a run with an eval round every epoch equals
  the straight run bit for bit (parameters, BN buffers, Adam state, step
  count, generators), the resumed process loading the classifiers the
  first one trained.
* ``calc_prd`` raises, naming what is missing.
"""

import csv
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from mopoe_mimic_tpu_torch import main as train_cli
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.evaluation.runner import run_eval_suite
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.train.scan import _train_tensors
from test_torch_port_eval_lr import KW, one_thread  # noqa: F401

FLAGSHIP_DEPTH = ["--batch_size", "8", "--synthetic_length", "32", "--end_epoch", "1",
                  "--steps_per_training_epoch", "2", "--eval_max_batches", "1",
                  "--clf_quick_epochs", "1", "--num_training_samples_lr", "16"]


def _csv_row(root: Path) -> dict:
    with open(root / "experiments_dataframe.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    return row


def test_flagship_main_runs_its_eval_rounds_on_the_cpu(tmp_path, caplog):
    argv = ["--config_path", "configs/flagship.json", "--dataset", "testing_structured",
            *FLAGSHIP_DEPTH, "--dir_experiment", str(tmp_path / "runs"),
            "--dir_clf", str(tmp_path / "clf"), "--device", "cpu"]
    with caplog.at_level(logging.INFO, logger="mopoe_mimic_tpu_torch"):
        result = train_cli.main(argv)
    cfg = MopoeConfig.from_cli(argv[:-2])
    assert cfg.eval_lr and cfg.use_clf and cfg.calc_nll and cfg.img_size == 128
    assert result["epochs_run"] == 1
    row = _csv_row(tmp_path / "runs")
    for prefix in ("lr_eval_", "gen_eval_", "likelihoods_"):
        keys = [k for k in row if k.startswith(prefix)]
        assert keys and all(row[k] != "" for k in keys), prefix
    assert np.isfinite(float(row["likelihoods_Lateral_PA_text_joint"]))
    assert len(list((tmp_path / "clf").rglob("clf_*.pt"))) == 3
    assert any("eval round:" in r.message for r in caplog.records)


def _small(tmp_path, **kw):
    return MopoeConfig(**{**KW, "dir_experiment": str(tmp_path / "runs"),
                          "dir_clf": str(tmp_path / "clf"), "eval_lr": True, "use_clf": True,
                          "calc_nll": True, "clf_quick_epochs": 1, "steps_per_training_epoch": 2,
                          "eval_max_batches": 1, **kw})


def test_eval_round_leaves_the_state_as_it_found_it(tmp_path):
    exp = Experiment(_small(tmp_path), device="cpu")
    state = exp.init_state()
    state.model.train()
    before = chip_smoke.train_state_tensors(state)
    before = {k: v.clone() for k, v in before.items()}
    addresses = [t.data_ptr() for t in _train_tensors(state) if t is not None]
    results = run_eval_suite(exp, state, epoch=0)
    exp.drain_host_jobs()
    assert results and state.model.training
    after = chip_smoke.train_state_tensors(state)
    assert after.keys() == before.keys()
    assert [k for k in before if not torch.equal(after[k], before[k])] == []
    assert [t.data_ptr() for t in _train_tensors(state) if t is not None] == addresses


def test_resume_with_eval_rounds_is_bitwise(tmp_path, caplog):
    base = ["--dataset", "testing_structured", "--batch_size", "8", "--class_dim", "4",
            "--DIM_img", "4", "--DIM_text", "4", "--img_size", "64", "--vocab_size", "50",
            "--compute_dtype", "float32", "--synthetic_length", "32", "--eval_lr", "true",
            "--use_clf", "true", "--calc_nll", "true", "--eval_freq", "1",
            "--eval_max_batches", "1", "--clf_quick_epochs", "1",
            "--num_training_samples_lr", "16", "--steps_per_training_epoch", "2",
            "--device_resident_data", "true", "--seed", "3", "--device", "cpu"]

    def run(name, *more):
        return train_cli.main([*base, "--dir_experiment", str(tmp_path / name),
                               "--dir_clf", str(tmp_path / name / "clf"), *more])

    straight = run("straight", "--end_epoch", "2")
    assert straight["epochs_run"] == 2
    ref = chip_smoke.train_state_tensors(straight["state"])
    run("resumed", "--end_epoch", "1")
    (run_dir,) = [p for p in (tmp_path / "resumed").iterdir() if p.name.startswith("Mimic")]
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="mopoe_mimic_tpu_torch"):
        # no --dir_clf: the resume takes the classifiers' directory from the
        # run's config.json and loads the .pt files its first segment wrote
        resumed = train_cli.main(["--load_run", str(run_dir), "--end_epoch", "2",
                                  "--device", "cpu"])
    assert resumed["epochs_run"] == 1
    assert sum("loaded classifier" in r.message for r in caplog.records) == 3
    assert not any("training classifier" in r.message for r in caplog.records)
    got = chip_smoke.train_state_tensors(resumed["state"])
    assert got.keys() == ref.keys()
    assert [k for k in ref if not torch.equal(got[k], ref[k])] == []
    for root in ("straight", "resumed"):
        row = _csv_row(tmp_path / root)
        assert row["total_epochs"] in ("1", "1.0") and row["lr_eval_PA_accuracy"] != ""


def test_calc_prd_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="models/inception.py"):
        Experiment(_small(tmp_path, calc_prd=True), device="cpu")
    exp = Experiment(_small(tmp_path), device="cpu")
    exp.cfg = exp.cfg.replace(calc_prd=True)
    with pytest.raises(NotImplementedError, match="evaluation/sample_quality.py"):
        run_eval_suite(exp, exp.init_state(), epoch=0)
