"""The port stands without JAX: importing every module of
mopoe_mimic_tpu_torch loads neither jax (nor flax, optax, orbax) nor any
module of the JAX package, and chip_smoke.py refuses to run, printing no
result, where there is no CUDA device or no port beside it.

Subprocesses: this test process already holds jax (tests/conftest.py).
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mopoe_mimic_tpu")

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
