"""Training callbacks: early stopping, ReduceLROnPlateau, periodic
checkpoints (mopoe_mimic_tpu/train/callbacks.py; reference Callbacks at
mimic/utils/experiment.py:286-402).

* ReduceLROnPlateau(patience=5, factor=0.1) on the test loss
  (experiment.py:298): scales every group's ``base_lr`` in place
  (``train/state.set_learning_rate``), which a captured train step reads at
  its next replay.
* Early stopping: stop when the test loss hasn't improved for
  ``max_early_stopping_index`` consecutive test epochs, counting only
  after ``start_early_stopping_epoch`` (experiment.py:317-336).
* Checkpoint every ``checkpoint_freq`` epochs and at the last epoch; an
  improvement between those is staged and written at the next one, or
  written at once by a manager that cannot stage (experiment.py:388-402,
  with the optimizer state, which the reference never saved).

The JAX package's loss-evolution plot (experiment.py:346-361) goes with the
plots of the evaluation, not ported yet.
"""

from __future__ import annotations

import math

from mopoe_mimic_tpu_torch.train.state import TrainState, get_learning_rate, set_learning_rate
from mopoe_mimic_tpu_torch.utils.logger import log


class ReduceLROnPlateau:
    def __init__(self, patience: int = 5, factor: float = 0.1, min_lr: float = 0.0):
        self.patience = patience
        self.factor = factor
        self.min_lr = min_lr
        self.best = math.inf
        self.bad_epochs = 0

    def step(self, state: TrainState, loss: float) -> TrainState:
        if loss < self.best:
            self.best = loss
            self.bad_epochs = 0
            return state
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            lr = max(get_learning_rate(state) * self.factor, self.min_lr)
            log.info(f"ReduceLROnPlateau: lowering lr to {lr:g}")
            self.bad_epochs = 0
            return set_learning_rate(state, lr)
        return state


class Callbacks:
    def __init__(self, cfg, checkpoint_manager=None, experiment_df=None):
        self.cfg = cfg
        self.ckpt = checkpoint_manager
        self.df = experiment_df
        self.scheduler = ReduceLROnPlateau() if cfg.reduce_lr_on_plateau else None
        self.best_loss = math.inf
        self.early_stopping_index = 0

    def update_epoch(self, epoch: int, test_loss: float, state: TrainState,
                     elapsed: float = 0.0) -> tuple[bool, TrainState]:
        """Returns (stop_training, the state)."""
        cfg = self.cfg
        if self.scheduler is not None:
            state = self.scheduler.step(state, test_loss)

        improved = test_loss < self.best_loss
        if improved:
            self.best_loss = test_loss
            self.early_stopping_index = 0
            if self.df is not None:
                self.df.update({"total_test_loss": test_loss, "best_epoch": epoch,
                                "mean_epoch_time": elapsed})
        elif epoch >= cfg.start_early_stopping_epoch:
            self.early_stopping_index += 1

        if self.ckpt is not None:
            boundary = (epoch + 1) % cfg.checkpoint_freq == 0 or epoch == cfg.end_epoch - 1
            stage = getattr(self.ckpt, "stage", None)
            if improved and cfg.checkpoint_on_improvement and stage is not None and not boundary:
                stage(epoch, state, {"test_loss": test_loss})
            elif boundary or (improved and cfg.checkpoint_on_improvement):
                try:
                    self.ckpt.save(epoch, state, metrics={"test_loss": test_loss})
                except TypeError:  # manager without metric support
                    self.ckpt.save(epoch, state)

        stop = self.early_stopping_index > cfg.max_early_stopping_index
        if stop:
            log.info(f"early stopping at epoch {epoch}: no improvement for "
                     f"{self.early_stopping_index} test epochs")
            if self.ckpt is not None and hasattr(self.ckpt, "flush_staged"):
                self.ckpt.flush_staged()  # persist the staged best now
        return stop, state
