"""Host-side batching: column-oriented numpy batches, the feed for a
dataset that does not fit on the card (``DeviceStore.fits``).

Port of ``mopoe_mimic_tpu/data/loader.py``, which replaces torch
DataLoader + DistributedSampler (mimic/dataio/utils.py:115-147):

  * datasets expose whole columns (``arrays``, ``labels``) so a batch is
    numpy slicing, no per-item collation;
  * shuffling is a seeded per-epoch permutation (``set_epoch``);
  * weighted sampling reproduces the WeightedRandomSampler path
    (dataio/utils.py:81-94): per-sample weight = inverse label-combination
    frequency (``_label_weights``, which ``DeviceStore.epoch_order`` shares);
  * ``drop_last=True``: a split smaller than one batch yields a single
    wraparound-padded batch (repeated rows, with a warning).

Batches are in the port's layouts: images NCHW (the datasets hold NHWC, as
the JAX package's), text as the dataset holds it.

Sharding (DistributedSampler parity): every process draws the same global
per-epoch order and keeps ``order[shard_index::num_shards]``, truncated to
equal shards; ``batch_size`` is the global batch. The shards default to
``torch.distributed``'s world size and rank where a process group is up.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)


def _default_shards() -> Tuple[int, int]:
    """(num_shards, shard_index) from ``torch.distributed``; (1, 0) without
    a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def to_port_layout(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Image columns (4-D, NHWC) → NCHW; other columns as they are."""
    return {k: np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if v.ndim == 4 else v
            for k, v in batch.items()}


class BatchLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        weighted: bool = False,
        drop_last: bool = True,
        num_shards: Optional[int] = None,
        shard_index: Optional[int] = None,
    ):
        if num_shards is None or shard_index is None:
            num_shards, shard_index = _default_shards()
        if not (0 <= shard_index < num_shards):
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        if batch_size % num_shards != 0:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly across "
                f"{num_shards} host shards"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.local_batch_size = batch_size // num_shards
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._weights = self._label_weights(np.asarray(dataset.labels)) if weighted else None

    @staticmethod
    def _label_weights(labels: np.ndarray) -> np.ndarray:
        """Inverse frequency of each label combination
        (dataio/utils.py:81-94)."""
        _, inverse, counts = np.unique(labels, axis=0, return_inverse=True, return_counts=True)
        w = 1.0 / counts[inverse.reshape(-1)]
        return w / w.sum()

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_order(self) -> np.ndarray:
        """This host's slice of the shared global per-epoch order."""
        n = len(self.dataset)
        rng = np.random.default_rng((self.seed, self.epoch))
        if self._weights is not None:
            order = rng.choice(n, size=n, replace=True, p=self._weights)
        elif self.shuffle:
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            usable = n - (n % self.num_shards)
            order = order[self.shard_index : usable : self.num_shards]
        return order

    def __len__(self) -> int:
        n = len(self._epoch_order())
        bs = self.local_batch_size
        if self.drop_last:
            # smaller than one batch: one wraparound-padded batch, not zero
            return max(n // bs, 1 if n > 0 else 0)
        return -(-n // bs)

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        order = self._epoch_order()
        cols = self.dataset.arrays
        labels = np.asarray(self.dataset.labels)
        bs = self.local_batch_size
        if self.drop_last and 0 < len(order) < bs:
            # a static batch shape: one wraparound-padded batch (repeated
            # rows) instead of an empty epoch that starves every consumer
            log.warning(f"BatchLoader: split has {len(order)} rows < batch_size {bs}; "
                        "yielding one wraparound-padded batch")
            idx = np.resize(order, bs)
            yield to_port_layout({k: v[idx] for k, v in cols.items()}), labels[idx]
            return
        for b in range(len(self)):
            idx = order[b * bs : (b + 1) * bs]
            yield to_port_layout({k: v[idx] for k, v in cols.items()}), labels[idx]
