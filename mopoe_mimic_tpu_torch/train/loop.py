"""Epoch orchestration (mopoe_mimic_tpu/train/loop.py; reference
mimic/run_epochs.py:31-272).

For each epoch: the train pass, the test pass, the heavy-eval round every
``eval_freq`` epochs, the callbacks (LR plateau, early stop, checkpoints)
and the sinks (TensorBoard, the results CSV). Under
``device_resident_data`` and ``scan_epochs`` each pass is one call of the
epoch runners of ``train/scan.py`` over the epoch's index matrix (a CUDA
graph of the step replayed a batch on the card); otherwise the steps of
``train/step.py`` run one by one over the store's batches or the host
``BatchLoader``'s (a host batch is moved to the card by the step). The
host reads the device once a pass: the epoch's means.

The eval round (``evaluation/runner.py``: lr-eval, coherence, the IWAE
likelihoods, the sample grids) runs after the test pass every
``eval_freq`` epochs, at the last epoch and at an early stop, and its
metrics join the results CSV (loop.py:113-128 of the JAX package); it
leaves the state as it found it, so a resumed run stays bit for bit its
straight twin. Its seconds are outside each epoch's train, test and
callback seconds.

Spans (``utils/profiling``), all inside ``loop.epoch`` (attribute
``epoch``): ``loop.train_pass`` and ``loop.test_pass``, each holding
``epoch.index_matrix`` (the host's matrix), the epoch runner's spans
(``scan.upload``, ``scan.graph_key``, ``scan.replays``,
``scan.read_means``) or the per-step loop, then ``loop.nan_check`` and
``loop.tb_write``; the eval round's ``eval.round``; ``loop.callbacks``,
holding ``loop.csv`` (each update of the results CSV, here and in the
callbacks), ``callbacks.update`` (the checkpoint manager's
``checkpoint.stage`` and ``checkpoint.write`` inside it) and
``loop.preemption_read``. The history's seconds are the durations of the
passes' and the callbacks' spans, and of the checkpoint writes among the
callbacks.

Not ported: prefetching host batches to the card (``parallel/prefetch.py``)
and the preemption flag's agreement across processes (the loop raises under
a ``torch.distributed`` group of more than one process).
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from mopoe_mimic_tpu_torch.evaluation.runner import run_eval_suite
from mopoe_mimic_tpu_torch.experiment import Experiment, require_device
from mopoe_mimic_tpu_torch.train.callbacks import Callbacks
from mopoe_mimic_tpu_torch.train.state import TrainState
from mopoe_mimic_tpu_torch.train.step import make_eval_step, make_train_step
from mopoe_mimic_tpu_torch.utils import profiling
from mopoe_mimic_tpu_torch.utils.exceptions import NaNInLatent
from mopoe_mimic_tpu_torch.utils.logger import log
from mopoe_mimic_tpu_torch.utils.meters import MetricAccumulator
from mopoe_mimic_tpu_torch.utils.preemption import PreemptionGuard

EVAL_RNG_OFFSET = 17  # the test pass's generator is seeded cfg.seed + 17 (loop.py:111)


def _at_most(iterable, n: Optional[int]):
    return itertools.islice(iterable, n) if n and n > 0 else iterable


def _single_process() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise NotImplementedError(
            "run_epochs in a torch.distributed group of more than one process: the agreement "
            "on the preemption flag (and the parallel path) is not ported")


def run_epochs(exp: Experiment, state: Optional[TrainState] = None, resume: bool = False,
               preemption="install", device: Union[str, torch.device] = "cuda"
               ) -> Dict[str, Any]:
    """Train ``exp`` from ``cfg.start_epoch`` (or, with ``resume``, the epoch
    after its latest checkpoint) to ``cfg.end_epoch``; returns the state, the
    last epoch's train and test means, the per-epoch history (losses, and the
    seconds of the train pass, the test pass, the callbacks and, of those,
    the checkpoint writes), the epochs run, whether a preemption ended the
    run, and the mean epoch time.

    ``device`` is where the run is asked to run (the card by default): it
    must be the experiment's. ``preemption``: "install" (default) hooks
    SIGTERM through a fresh ``PreemptionGuard``, and a notice checkpoints at
    the next epoch boundary and returns ``preempted=True``; pass a guard to
    share one, or None to disable."""
    device = require_device(device)
    if device != exp.device:
        raise ValueError(f"run_epochs on {device}: the experiment lives on {exp.device}")
    _single_process()
    cfg = exp.cfg
    own_guard = preemption == "install"
    guard = PreemptionGuard().install() if own_guard else preemption
    train_loader, test_loader = exp.make_loaders()

    stores = exp.stores()
    store_train, store_test = stores if stores is not None else (None, None)
    if store_train is None and device.type == "cuda":
        from mopoe_mimic_tpu_torch.data.device_store import DeviceStore

        if DeviceStore.fits(exp.dataset_train, cfg, device=device):
            log.info("dataset fits on the card: --device_resident_data true gathers each "
                     "batch there instead of copying it from the host")

    state = state if state is not None else exp.init_state()
    start_epoch = cfg.start_epoch
    if resume and exp.checkpoints is not None and exp.checkpoints.latest_epoch() is not None:
        start_epoch, state = exp.checkpoints.restore(state)
        start_epoch += 1
        log.info(f"resumed from checkpoint at epoch {start_epoch}")

    scan = cfg.scan_epochs and store_train is not None
    if scan:
        from mopoe_mimic_tpu_torch.train.scan import (
            epoch_index_matrix,
            make_eval_epoch,
            make_train_epoch,
        )

        train_epoch_fn = make_train_epoch(cfg, store_train)
        eval_epoch_fn = make_eval_epoch(cfg, store_test)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    callbacks = Callbacks(cfg, exp.checkpoints, exp.experiments_df)
    eval_gen = torch.Generator(device).manual_seed((cfg.seed or 0) + EVAL_RNG_OFFSET)

    steps_cap = cfg.steps_per_training_epoch if cfg.steps_per_training_epoch > 0 else None
    last_test: Dict[str, Any] = {}
    train_avg: Dict[str, Any] = {}
    test_avg: Dict[str, Any] = {}
    epoch_times = []
    history = []  # per epoch: losses and the seconds of each part
    preempted = False

    def saved_ns() -> int:
        return exp.checkpoints.save_ns if exp.checkpoints is not None else 0

    def run_heavy_evals(epoch: int) -> None:
        """The eval round (``evaluation/runner.py``); its metrics join the
        run's CSV row."""
        eval_results = run_eval_suite(exp, state, epoch)
        if eval_results and exp.experiments_df is not None:
            exp.experiments_df.update(eval_results)

    try:
        for epoch in range(start_epoch, cfg.end_epoch):
            with profiling.span("loop.epoch", epoch=epoch) as epoch_span:
                # ---- train pass --------------------------------------------
                with profiling.span("loop.train_pass") as train_pass:
                    train_loader.set_epoch(epoch)
                    with profiling.span("epoch.index_matrix"):
                        idx_mat = (epoch_index_matrix(store_train, epoch, cfg.batch_size,
                                                      seed=cfg.seed or 0,
                                                      weighted=cfg.weighted_sampler,
                                                      steps_cap=steps_cap)
                                   if scan else None)
                    if idx_mat is not None and len(idx_mat):
                        state, train_avg = train_epoch_fn(state, idx_mat)
                    else:
                        acc = MetricAccumulator()
                        if store_train is not None:
                            train_iter = _at_most(store_train.iter_epoch(
                                epoch, cfg.batch_size, seed=cfg.seed or 0,
                                weighted=cfg.weighted_sampler), steps_cap)
                        else:
                            train_iter = _at_most(iter(train_loader), steps_cap)
                        for batch, _labels in train_iter:
                            acc.update(train_step(state, batch))
                        train_avg = acc.averages()
                    _pass_end(exp, cfg, "train", epoch, train_avg)

                # ---- test pass ---------------------------------------------
                with profiling.span("loop.test_pass") as test_pass:
                    test_loader.set_epoch(epoch)
                    with profiling.span("epoch.index_matrix"):
                        test_idx = (epoch_index_matrix(store_test, epoch, cfg.batch_size,
                                                       seed=(cfg.seed or 0) + 1,
                                                       steps_cap=steps_cap)
                                    if scan else None)
                    if test_idx is not None and len(test_idx):
                        eval_gen, test_avg = eval_epoch_fn(state, eval_gen, test_idx)
                    else:
                        acc = MetricAccumulator()
                        if store_test is not None:
                            test_iter = _at_most(store_test.iter_epoch(
                                epoch, cfg.batch_size, seed=(cfg.seed or 0) + 1), steps_cap)
                        else:
                            test_iter = _at_most(iter(test_loader), steps_cap)
                        for batch, _labels in test_iter:
                            acc.update(eval_step(state, batch, eval_gen))
                        test_avg = acc.averages()
                    _pass_end(exp, cfg, "test", epoch, test_avg)
                    last_test = test_avg

                # ---- eval round every eval_freq epochs ------------------------
                evals_ran = (epoch + 1) % cfg.eval_freq == 0 or epoch == cfg.end_epoch - 1
                if evals_ran:
                    run_heavy_evals(epoch)

                # ---- callbacks -----------------------------------------------
                with profiling.span("loop.callbacks") as callbacks_span:
                    test_loss = float(test_avg["total_loss"])
                    train_loss = float(train_avg["total_loss"])
                    elapsed = (time.perf_counter_ns() - epoch_span.start_ns) / 1e9
                    epoch_times.append(elapsed)
                    log.info(f"epoch {epoch}: train_loss={train_loss:.4f} "
                             f"test_loss={test_loss:.4f} ({elapsed:.1f}s: "
                             f"train={train_pass.seconds:.1f} test={test_pass.seconds:.1f})")
                    if exp.experiments_df is not None:
                        exp.experiments_df.update({"total_epochs": epoch,
                                                   "mean_epoch_time": float(np.mean(epoch_times))})
                    saved_before = saved_ns()
                    with profiling.span("callbacks.update"):
                        stop, state = callbacks.update_epoch(epoch, test_loss, state, elapsed)
                    with profiling.span("loop.preemption_read"):
                        preempted = not stop and guard is not None and guard.requested
                    if preempted:
                        log.warning(f"preemption: checkpointing at epoch {epoch} and exiting "
                                    "— resume by reattaching to this run dir: --load_run "
                                    f"{exp.paths.get('experiment_run', '<run_dir>')}")
                        if exp.checkpoints is not None:
                            exp.checkpoints.save(epoch, state, force=True,
                                                 metrics={"test_loss": test_loss})
                seconds = {"train": train_pass.seconds, "test": test_pass.seconds,
                           "callbacks": callbacks_span.seconds,
                           "checkpoint": (saved_ns() - saved_before) / 1e9}
                history.append({"epoch": epoch, "train_loss": train_loss,
                                "test_loss": test_loss, "seconds": seconds})
                log.info(f"epoch {epoch} split: train pass {seconds['train']:.3f} s, test pass "
                         f"{seconds['test']:.3f} s, callbacks {seconds['callbacks']:.3f} s "
                         f"(checkpoint write {seconds['checkpoint']:.3f} s)")
                if stop and not evals_ran:
                    # an early-stopped run must not ship metrics eval_freq epochs stale
                    run_heavy_evals(epoch)
            if stop or preempted:
                break
    finally:
        if own_guard and guard is not None:
            guard.uninstall()
        exp.drain_host_jobs()

    # durable on return: the staged best written
    if exp.checkpoints is not None:
        exp.checkpoints.wait_until_finished()

    return {"state": state, "train": train_avg, "test": last_test, "history": history,
            "epochs_run": len(epoch_times), "preempted": preempted,
            "mean_epoch_time": float(np.mean(epoch_times)) if epoch_times else 0.0}


def _pass_end(exp: Experiment, cfg, split: str, epoch: int, avg: Dict[str, Any]) -> None:
    """A pass's NaN check and TensorBoard write, each its own span."""
    with profiling.span("loop.nan_check"):
        _check_nans(cfg, avg)
    with profiling.span("loop.tb_write"):
        exp.tb_logger.write_epoch(split, epoch, _loggable(avg))


def _check_nans(cfg, avg: Dict[str, Any]) -> None:
    """Raise NaNInLatent like check_latents (mimic/utils/utils.py:201-208);
    relaxed for the synthetic dataset exactly like the reference."""
    if cfg.dataset.lower().startswith("testing"):
        return
    if float(avg.get("nan_in_latents", 0.0)) > 0.0:
        raise NaNInLatent("latent representations contain NaNs")


def _loggable(avg: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in avg.items() if k != "nan_in_latents"}
