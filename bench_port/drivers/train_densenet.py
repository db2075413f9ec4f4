"""The ``train_densenet`` driver: the ``train`` driver (``drivers/train.py``:
its set-up, window, ``first_steps`` and ``compare``) on a configuration
whose X-ray encoders are DenseNet-121, checked against
``reference/densenet.py``.

It runs a private copy of ``drivers/train.py`` whose seeded weights and
reference steps build the DenseNet reference: that module looks up
``MMVae`` and ``model_sizes`` (in ``seeded_weights_for``) and
``reference_steps`` (in ``reference_readings``) as module globals, and the
copy's point at a private copy of ``reference/training.py`` whose own
``MMVae`` and ``model_sizes`` are the DenseNet reference's. The files
themselves are shared with the ``train`` cells and left as they are.

Beside the ``train`` driver's readings: ``densenet_counts``, the program's
``densenet.*`` counters over the last training epoch's call, a step
(``models/densenet.COUNTS``; each replay of the step's graph adds what its
capture counted).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from reference import densenet

BENCH_DIR = Path(__file__).resolve().parent.parent


def _copy_of(path: Path, name: str, **overrides):
    """The module at ``path`` loaded anew as ``name``, its globals
    ``overrides`` replaced."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for key, value in overrides.items():
        if not hasattr(mod, key):  # a renamed global would leave the copy on its own
            raise AttributeError(f"{path.name} has no global {key!r} to replace")
        setattr(mod, key, value)
    return mod


training = _copy_of(BENCH_DIR / "reference" / "training.py", "bench_reference_training_densenet",
                    MMVae=densenet.MMVae, model_sizes=densenet.model_sizes)
base = _copy_of(BENCH_DIR / "drivers" / "train.py", "bench_driver_train_for_densenet",
                MMVae=densenet.MMVae, model_sizes=densenet.model_sizes,
                reference_steps=training.reference_steps)
_first_steps = base.first_steps


def counted_steps(counts: dict):
    """``first_steps`` whose epoch function also writes into ``counts`` the
    program's ``densenet.*`` counters a step over each call."""

    def first_steps(make_train_epoch, weights_host, record, fault=""):
        from mopoe_mimic_tpu_torch.models.densenet import COUNTS

        make = _first_steps(make_train_epoch, weights_host, record, fault)

        def make_counted(*args, **kwargs):
            epoch_fn = make(*args, **kwargs)

            def train_epoch(state, idx_mat):
                before = dict(COUNTS)
                out = epoch_fn(state, idx_mat)
                counts.update({k: (COUNTS[k] - before[k]) / len(idx_mat) for k in COUNTS})
                return out

            return train_epoch

        return make_counted

    return first_steps


def run(ctx: dict) -> dict:
    counts: dict = {}
    base.first_steps = counted_steps(counts)
    readings = base.run(ctx)
    if not counts:  # drivers/train.py no longer takes first_steps as a module global
        raise RuntimeError("the program's densenet.* counters were not read")
    readings["densenet_counts"] = counts
    return readings
