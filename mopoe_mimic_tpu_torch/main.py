"""The training CLI (mopoe_mimic_tpu/main.py; reference
mimic/main_mimic.py:25-127).

    python -m mopoe_mimic_tpu_torch.main --config_path configs/flagship.json \\
        --dataset testing --eval_lr false --calc_nll false --use_clf false \\
        --device_resident_data true --fused_text_head true \\
        --bn_compute_dtype compute --lr_warmup_steps 300

Every ``MopoeConfig`` field is a flag (``config.py``), over the JSON of
``--config_path``. Besides: ``--load_run RUN_DIR`` reattaches to a run
directory and resumes from its latest checkpoint, with its persisted
``config.json`` under the flags given on this command line (which win);
of the persisted paths it keeps ``dir_clf``, so that a resume's coherence
rounds read the classifiers that the run's first segment trained (the run
persists ``dir_clf`` as an absolute path);
``--load_flags PATH`` overlays another persisted config;
``--autotune_batch_size`` doubles the batch while a train step fits on the
card (``train/autotune.py``); ``--device`` is where to run (``cuda``, the
default, or ``cpu``: without a card the default raises).

Supervision:
  * NaN in the latents: restart from scratch with a fresh seed, up to
    ``MAX_NAN_RESTARTS`` times, wiping the run directory and its CSV row
    (main_mimic.py:39, 79-114).
  * The card out of memory (``torch.cuda.OutOfMemoryError``): the batch
    × 0.8, down to 8, and run again (main_mimic.py:116-121). The failed
    run's tensors are released and the allocator's cache emptied before
    the retry. An OOM inside a CUDA-graph capture may leave the capture's
    memory pool allocated in the process; the retry then runs beside it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.experiment import Experiment, require_device
from mopoe_mimic_tpu_torch.train.autotune import free_device_memory, is_oom_error
from mopoe_mimic_tpu_torch.train.loop import run_epochs
from mopoe_mimic_tpu_torch.utils.exceptions import NaNInLatent
from mopoe_mimic_tpu_torch.utils.logger import log

MAX_NAN_RESTARTS = 10
OOM_BACKOFF, MIN_BATCH = 0.8, 8


class Main:
    def __init__(self, cfg: MopoeConfig, run_name: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.device = require_device(device)
        self.cfg = cfg
        self.run_name = run_name  # reattach to this run dir (--load_run)
        self.restarts = 0

    def _run_once(self):
        exp = Experiment(self.cfg, name=self.run_name, device=self.device)
        self.last_run_dir = exp.paths.get("experiment_run", "")
        log.info(f"starting experiment {exp.name}")
        try:
            return run_epochs(exp, resume=bool(self.cfg.start_epoch) or self.run_name is not None,
                              device=self.device)
        except NaNInLatent:
            self._wipe(exp)
            raise
        finally:
            exp.tb_logger.close()
            if exp.checkpoints is not None:
                exp.checkpoints.close()

    def _wipe(self, exp: Experiment) -> None:
        log.warning(f"wiping failed experiment dir {exp.paths['experiment_run']}")
        shutil.rmtree(exp.paths["experiment_run"], ignore_errors=True)
        if exp.experiments_df is not None:
            exp.experiments_df.delete_row()

    def main(self):
        t0 = time.time()
        while True:
            out_of_memory = None
            try:
                result = self._run_once()
                break
            except NaNInLatent as e:
                self.restarts += 1
                if self.restarts > MAX_NAN_RESTARTS:
                    log.error(f"giving up after {self.restarts} NaN restarts")
                    raise
                seed = int(np.random.default_rng().integers(0, 10000))
                log.warning(f"NaN in latents ({e}); restart {self.restarts} with seed {seed}")
                self.cfg = self.cfg.replace(seed=seed)
            except Exception as e:
                if not is_oom_error(e):
                    raise
                new_bs = int(self.cfg.batch_size * OOM_BACKOFF)
                if new_bs < MIN_BATCH:
                    raise
                out_of_memory = (str(e).splitlines()[0] if str(e) else type(e).__name__, new_bs)
            if out_of_memory is not None:
                # out of the handler: the failed run's traceback, and with it
                # its tensors, are gone before the cache is emptied
                free_device_memory()
                log.warning(f"device out of memory ({out_of_memory[0]}); retrying with "
                            f"batch_size={out_of_memory[1]}")
                self.cfg = self.cfg.replace(batch_size=out_of_memory[1])
        if result.get("preempted"):
            log.warning("run exited on a preemption notice (SIGTERM) with a saved checkpoint — "
                        f"resume with: --load_run {getattr(self, 'last_run_dir', '<run_dir>')}")
        log.info(f"experiment finished in {(time.time() - t0) / 60:.1f} min")
        return result


def load_flags(cfg: MopoeConfig, path: str, skip=()) -> MopoeConfig:
    """Overlay the hyperparameters of a persisted config, keeping this
    run's paths (--load_flags, flags.py:159-163); ``skip``: the fields set
    on this command line, which win."""
    with open(path) as f:
        old = json.load(f)
    known = {f.name for f in dataclasses.fields(MopoeConfig)}
    params = {k: v for k, v in old.items()
              if k in known and k not in skip and "dir" not in k and "path" not in k}
    return cfg.replace(**params)


def persisted_dir_clf(run_dir: str, default: str) -> str:
    """The ``dir_clf`` of the run directory's ``config.json`` (``default``
    where there is none): the classifiers that the run's evaluation rounds
    trained or loaded are the ones its resume must load."""
    path = os.path.join(run_dir, "config.json")
    if not os.path.exists(path):
        return default
    with open(path) as f:
        return json.load(f).get("dir_clf", default)


def _pop_option(argv: list, name: str) -> Optional[str]:
    """The value of ``name VALUE`` in argv, removed from it (None if absent)."""
    if name not in argv:
        return None
    i = argv.index(name)
    value = argv[i + 1]
    del argv[i: i + 2]
    return value


def main(argv=None, device: Union[str, torch.device] = "cuda"):
    argv = list(argv if argv is not None else sys.argv[1:])
    flags_path = _pop_option(argv, "--load_flags")
    run_dir = _pop_option(argv, "--load_run")
    device = _pop_option(argv, "--device") or device
    autotune = "--autotune_batch_size" in argv
    if autotune:
        argv.remove("--autotune_batch_size")
    # the fields set on this command line win over a persisted config
    explicit_keys = {tok[2:].split("=", 1)[0] for tok in argv if tok.startswith("--")}
    device = require_device(device)
    cfg = MopoeConfig.from_cli(argv)
    run_name_arg = None
    if run_dir:
        run_dir = run_dir.rstrip("/")
        run_name_arg = os.path.basename(run_dir)
        parent = os.path.dirname(run_dir)
        if parent:
            cfg = cfg.replace(dir_experiment=parent)
        if flags_path is None:
            persisted = os.path.join(run_dir, "config.json")
            if os.path.exists(persisted):
                flags_path = persisted
    if flags_path:
        cfg = load_flags(cfg, flags_path, skip=explicit_keys)
    if run_dir and "dir_clf" not in explicit_keys:
        cfg = cfg.replace(dir_clf=persisted_dir_clf(run_dir, cfg.dir_clf))
    cfg = cfg.replace(dir_clf=os.path.abspath(os.path.expanduser(cfg.dir_clf)))
    if cfg.seed is None:
        cfg = cfg.replace(seed=int(np.random.default_rng().integers(0, 10000)))
    if autotune:
        from mopoe_mimic_tpu_torch.train.autotune import autotune_batch_size

        tuned = autotune_batch_size(cfg, device=device)
        if tuned != cfg.batch_size:
            log.info(f"autotuned batch_size {cfg.batch_size} → {tuned}")
            cfg = cfg.replace(batch_size=tuned)
    return Main(cfg, run_name=run_name_arg, device=device).main()


if __name__ == "__main__":
    main(sys.argv[1:])
