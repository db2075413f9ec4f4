"""The port stands without JAX: importing every module of
mopoe_mimic_tpu_torch loads neither jax (nor flax, optax, orbax) nor any
module of the JAX package, nor scikit-learn or pandas, which the card's
machine does not have, also from a copy of the tree that has no
``mopoe_mimic_tpu/`` (where a train step runs too), and chip_smoke.py
refuses to run, printing no result, where there is no CUDA device or no
port beside it.

Subprocesses: this test process already holds jax (tests/conftest.py).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mopoe_mimic_tpu", "sklearn", "pandas")

IMPORT_ALL = f"""
import importlib, pkgutil, sys
import mopoe_mimic_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(k for k in sys.modules if k.split(".")[0] in {FORBIDDEN!r})
print("imported", len(names), "modules")
print("forbidden", bad)
"""


def _env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a machine that has one
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "forbidden []" in proc.stdout, proc.stdout
    n = int(proc.stdout.split("imported ")[1].split()[0])
    assert n >= 12, proc.stdout  # config, ops/*, models/*, serve


def test_chip_smoke_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


ALONE = IMPORT_ALL + """
import importlib.util
assert importlib.util.find_spec("mopoe_mimic_tpu") is None
import numpy as np
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import make_train_step
flagship = MopoeConfig.from_json("configs/flagship.json")
cfg = flagship.replace(img_size=64, DIM_img=4, DIM_text=4, class_dim=4, vocab_size=30,
                       batch_size=2, compute_dtype="float32", fused_text_head=True,
                       fused_pointwise=True)
rng = np.random.default_rng(0)
batch = {"PA": rng.random((2, 1, 64, 64), dtype=np.float32),
         "Lateral": rng.random((2, 1, 64, 64), dtype=np.float32),
         "text": rng.integers(0, 30, (2, 128))}
state = create_train_state(cfg, device="cpu", seed=0)
loss = float(make_train_step(cfg)(state, batch)["total_loss"])
assert np.isfinite(loss), loss
bad = sorted(k for k in sys.modules if k.split(".")[0] in {FORBIDDEN!r})
print("step ok", flagship.DIM_img, "forbidden", bad)
"""


def test_port_runs_from_a_tree_without_the_jax_package(tmp_path):
    """mopoe_mimic_tpu_torch/, chip_smoke.py and configs/ alone: every port
    module and chip_smoke import, the flagship config loads, and a train
    step with fused_text_head and fused_pointwise runs on the CPU."""
    shutil.copytree(ROOT / "mopoe_mimic_tpu_torch", tmp_path / "mopoe_mimic_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(ROOT / "configs", tmp_path / "configs")
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    assert not (tmp_path / "mopoe_mimic_tpu").exists()
    proc = subprocess.run([sys.executable, "-c", ALONE.replace("{FORBIDDEN!r}", repr(FORBIDDEN))],
                          cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "forbidden []" in proc.stdout and "step ok 64 forbidden []" in proc.stdout, proc.stdout
