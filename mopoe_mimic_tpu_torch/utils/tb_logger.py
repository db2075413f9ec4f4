"""TensorBoard sink (mopoe_mimic_tpu/utils/tb_logger.py; reference
mimic/utils/TBLogger.py): scalars by split and name, and the eval round's
sample grids as images, step = epoch. Backed by
``torch.utils.tensorboard`` where the ``tensorboard`` package imports, else
a no-op (the metrics still reach the results CSV), as the JAX package's
sink without tensorboardX."""

from __future__ import annotations

import math
from typing import Any, Mapping, Optional

import numpy as np

from mopoe_mimic_tpu_torch.utils.meters import flatten_metrics


def _summary_writer(logdir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(logdir)


class TBLogger:
    def __init__(self, name: str, logdir: Optional[str]):
        self.name = name
        self.writer = _summary_writer(logdir) if logdir else None

    def write_epoch(self, split: str, epoch: int, metrics: Mapping[str, Any]) -> None:
        """metrics: a (nested) tree of floats, an epoch's means."""
        if self.writer is None:
            return
        for key, val in flatten_metrics(metrics).items():
            if isinstance(val, float) and math.isfinite(val):
                self.writer.add_scalar(f"{split}/{key}", val, epoch)

    def write_image(self, tag: str, img_hwc: np.ndarray, epoch: int) -> None:
        """An [H, W, C] image in [0, 1]."""
        if self.writer is not None:
            self.writer.add_image(tag, img_hwc, epoch, dataformats="HWC")

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
