"""The experiment container: config → data → train state → sinks
(mopoe_mimic_tpu/experiment.py; reference MimicExperiment,
mimic/utils/experiment.py:40-283): the datasets, the modality set and its
subsets, the data feeds (``make_loaders``, ``stores``, ``eval_batches``),
the train state (``init_state``), the run directory with its
``config.json``, the checkpoint manager, the results-CSV row and
TensorBoard, and a host worker for jobs off the epoch path.

The experiment lives on ``device``: the card unless the caller asks for the
CPU; without a card it raises rather than falling back. The synthetic
datasets (``testing``, ``testing_structured``) are ported; the MIMIC store
(``data/mimic_dataset.py``) is not, and a run on it raises. Of the heavy
evaluations (``evaluation/``), lr-eval (``eval_lr``), coherence with its
classifiers (``use_clf``) and the IWAE likelihoods (``calc_nll``) are
ported; PRD/FID (``calc_prd``) and the DenseNet classifier are not, and a
run that asks for either raises at construction instead of looking
evaluated. The evaluations read ``labels`` and ``subsets`` and keep
per-run objects in ``cached``.
"""

from __future__ import annotations

import concurrent.futures
import json
import time
from typing import Optional, Union

import torch

from mopoe_mimic_tpu_torch.data.loader import BatchLoader
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.ops.fusion import subset_powerset
from mopoe_mimic_tpu_torch.train.state import TrainState, create_train_state
from mopoe_mimic_tpu_torch.utils.checkpoints import CheckpointManager
from mopoe_mimic_tpu_torch.utils.experiment_df import ExperimentDataframe
from mopoe_mimic_tpu_torch.utils.filehandling import create_dir_structure, run_name
from mopoe_mimic_tpu_torch.utils.logger import log
from mopoe_mimic_tpu_torch.utils.tb_logger import TBLogger

HEAVY_EVALS = ("eval_lr", "use_clf", "calc_nll", "calc_prd")
PRD_MISSING = ("calc_prd=True: PRD/FID sample quality (evaluation/sample_quality.py, "
               "evaluation/embedding.py) and its Inception network (models/inception.py) are "
               "not ported (ROADMAP queue 1 items 8-9); pass --calc_prd false")
DROPOUT_SEED_OFFSET = 29  # the default generator's seed is cfg.seed + 29
# CheXpert labels used for evaluation (dataio/utils.py:183-187)
LABELS = ["Lung Opacity", "Pleural Effusion", "Support Devices"]
BINARY_LABELS = ["Finding"]


def require_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is no card
    raises (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


class Experiment:
    def __init__(self, cfg, make_dirs: bool = True, name: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        """``name``: reattach to an existing run directory (resume after a
        restart or a preemption) instead of making a new timestamped one."""
        self.device = require_device(device)
        if cfg.calc_prd:
            raise NotImplementedError(PRD_MISSING)
        if cfg.use_clf and cfg.img_clf_type == "densenet":
            from mopoe_mimic_tpu_torch.train.clf_trainer import DENSENET_MISSING

            raise NotImplementedError(DENSENET_MISSING)
        if cfg.dataset.lower() not in ("testing", "testing_structured"):
            raise NotImplementedError(
                f"dataset {cfg.dataset!r}: the MIMIC store (data/mimic_dataset.py) is not "
                "ported; the port trains on dataset 'testing' or 'testing_structured'")
        self.cfg = cfg
        self.labels = BINARY_LABELS if cfg.binary_labels else LABELS
        self.subsets = subset_powerset(cfg.modality_names)
        self.name = name or run_name(cfg)
        self.paths = create_dir_structure(cfg, self.name, train=make_dirs)
        self.set_datasets()
        self.tb_logger = TBLogger(self.name, self.paths["logs"] if make_dirs else None)
        self.experiments_df: Optional[ExperimentDataframe] = None
        self.checkpoints: Optional[CheckpointManager] = None
        if make_dirs:
            self.experiments_df = ExperimentDataframe(
                f"{cfg.dir_experiment}/experiments_dataframe.csv", cfg, self.name)
            self.checkpoints = CheckpointManager(self.paths["checkpoints"])
            # the full config, for --load_flags / --load_run and audits
            with open(f"{self.paths['experiment_run']}/config.json", "w") as f:
                json.dump(cfg.to_dict(), f, indent=2, default=str)

    # ------------------------------------------------------------------

    def set_datasets(self) -> None:
        cfg = self.cfg
        if cfg.dataset.lower() == "testing_structured":
            n = cfg.synthetic_length or 2 * cfg.batch_size
            kw = dict(structured=True, n_classes=cfg.synthetic_classes, noise=cfg.synthetic_noise)
            self.dataset_train = SyntheticMimic(cfg, seed=0, length=n, **kw)
            self.dataset_test = SyntheticMimic(cfg, seed=1, length=max(n // 4, cfg.batch_size),
                                               **kw)
        else:
            self.dataset_train = SyntheticMimic(cfg, seed=0, length=cfg.synthetic_length)
            self.dataset_test = SyntheticMimic(cfg, seed=1, length=cfg.synthetic_length)

    def make_loaders(self):
        cfg = self.cfg
        train_loader = BatchLoader(self.dataset_train, cfg.batch_size,
                                   shuffle=not cfg.weighted_sampler, seed=cfg.seed or 0,
                                   weighted=cfg.weighted_sampler)
        test_loader = BatchLoader(self.dataset_test, cfg.batch_size, shuffle=True,
                                  seed=(cfg.seed or 0) + 1)
        return train_loader, test_loader

    def stores(self):
        """(train, test) ``DeviceStore``s on the experiment's device under
        ``cfg.device_resident_data``, else None; built once and shared by
        the loop and every eval."""
        if not self.cfg.device_resident_data:
            return None
        if getattr(self, "_stores", None) is None:
            from mopoe_mimic_tpu_torch.data.device_store import DeviceStore

            self._stores = (DeviceStore(self.dataset_train, self.cfg, device=self.device),
                            DeviceStore(self.dataset_test, self.cfg, device=self.device))
        return self._stores

    def cached(self, key, builder):
        """``builder()``'s result, built once per ``key`` for the life of the
        experiment: objects fixed for a run (the BLEU reference tables of
        the test set)."""
        cache = self.__dict__.setdefault("_cache", {})
        if key not in cache:
            cache[key] = builder()
        return cache[key]

    def submit_host_job(self, fn, name: str = "") -> None:
        """Run ``fn`` on the experiment's one host worker thread, in
        submission order, off the epoch path; failures are logged, not
        raised."""
        ex = self.__dict__.get("_host_worker")
        if ex is None:
            ex = self._host_worker = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="host-jobs")
            self._host_jobs = []

        def run():
            t0 = time.perf_counter()
            try:
                fn()
                log.info(f"host job '{name or fn!r}' finished in "
                         f"{time.perf_counter() - t0:.1f}s (off the epoch path)")
            except Exception as e:  # noqa: BLE001 — the worker must not die
                log.warning(f"host job '{name}' FAILED: {e!r}", exc_info=True)

        self._host_jobs.append(ex.submit(run))

    def drain_host_jobs(self) -> None:
        """Block until every submitted host job has finished (the loop's
        end, the NaN-restart path included)."""
        for f in self.__dict__.get("_host_jobs") or []:
            f.result()
        self._host_jobs = []

    def eval_batches(self, split: str = "test", epoch: int = 0):
        """(batch, labels) iterator for evaluation: gathered on the device
        from the store where there is one, else a fresh seeded loader with
        the order of ``make_loaders``'."""
        cfg = self.cfg
        seed = (cfg.seed or 0) + (1 if split == "test" else 0)
        bs = cfg.effective_eval_batch_size
        st = self.stores()
        if st is not None:
            store = st[0] if split == "train" else st[1]
            return store.iter_epoch(epoch, bs, shuffle=True, seed=seed)
        if bs == cfg.batch_size:
            train_loader, test_loader = self.make_loaders()
            loader = train_loader if split == "train" else test_loader
        else:
            ds = self.dataset_train if split == "train" else self.dataset_test
            loader = BatchLoader(ds, bs, shuffle=True, seed=seed)
        loader.set_epoch(epoch)
        return iter(loader)

    def init_state(self) -> TrainState:
        """A fresh train state on the experiment's device, from ``cfg.seed``;
        dropout's generator, the default one, seeded from it too (offset by
        ``DROPOUT_SEED_OFFSET``: the state's generator, which draws the
        reparameterisation noise, has ``cfg.seed`` itself), so that a run is
        reproducible and a resume continues it bit for bit."""
        seed = self.cfg.seed or 0
        torch.manual_seed(seed + DROPOUT_SEED_OFFSET)
        return create_train_state(self.cfg, self.device, seed=seed)
