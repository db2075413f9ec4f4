"""The run name and the run-directory tree, the same paths as the JAX
package's (mopoe_mimic_tpu/utils/filehandling.py; reference
mimic/utils/filehandling.py:12-89): checkpoints/, logs/,
generation_evaluation/, inference/, fid/, plots/{random_samples, cond_gen,
swapping} under ``dir_experiment/<run name>``."""

from __future__ import annotations

import datetime
import os
from pathlib import Path
from typing import Dict


def run_name(cfg) -> str:
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S_%f")
    return f"{cfg.exp_str_prefix}_{cfg.method}_{stamp}"


def create_dir_structure(cfg, name: str = "", train: bool = True) -> Dict[str, str]:
    """The path map; with ``train``, every directory made (mkdir -p)."""
    name = name or run_name(cfg)
    root = Path(cfg.dir_experiment).expanduser() / name
    paths = {
        "experiment_run": str(root),
        "checkpoints": str(root / "checkpoints"),
        "logs": str(root / "logs"),
        "gen_eval": str(root / "generation_evaluation"),
        "inference": str(root / "inference"),
        "fid": str(cfg.dir_fid or root / "fid"),
        "plots": str(root / "plots"),
        "plot_random": str(root / "plots" / "random_samples"),
        "plot_cond": str(root / "plots" / "cond_gen"),
        "plot_swap": str(root / "plots" / "swapping"),
    }
    if train:
        for p in paths.values():
            os.makedirs(p, exist_ok=True)
    return paths
