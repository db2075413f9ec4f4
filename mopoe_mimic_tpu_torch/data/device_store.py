"""Card-resident dataset: the store lives in device memory and batches are
gathered on the card, so the only per-step input is the [B] index vector.

Port of ``mopoe_mimic_tpu/data/device_store.py``:

  * images as raw uint8 (4× smaller than float32; lossless for a uint8
    source, ≤ 1/510 quantization for a float one), stored in the port's
    NCHW layout, transposed once at upload, so a gather needs no transpose;
  * text as ids (int32 word ids, uint8 char ids); the char one-hot over
    ``ALPHABET`` is made per batch on the card, never stored;
  * the gather (``gather_fn``) is ``index_select`` on the card, then the
    dequantisation ``x.float() * float32(1/255)``: XLA compiles the JAX
    store's ``x / 255.0`` into that product, so the gathered batch equals
    the JAX store's bit for bit (after the NHWC → NCHW transpose), on the
    CPU and on the card alike.

``train/scan.py`` captures ``gather_fn`` into the epoch's CUDA graph.
``fits`` checks the store's bytes against the card's free memory. The
span ``store.build`` times the construction: ``store.fetch`` (the host's
compact columns) and ``store.upload`` (their copy to the device). A
sharded store (``mesh``, ``shard_rows``) is not ported yet.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from mopoe_mimic_tpu_torch.data.alphabet import ALPHABET
from mopoe_mimic_tpu_torch.data.loader import BatchLoader
from mopoe_mimic_tpu_torch.utils import profiling

log = logging.getLogger(__name__)


def _compact_images(col: np.ndarray) -> np.ndarray:
    """Image column → uint8 (a float column in [0, 1] quantised)."""
    arr = np.asarray(col)
    if arr.dtype == np.uint8:
        return arr
    return np.round(np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


class DeviceStore:
    """Upload a dataset's columns to the card once; gather batches there.

    Parameters
    ----------
    dataset: a dataset with ``arrays`` column views (images NHWC) and
        ``labels`` (``SyntheticMimic``).
    cfg: supplies the text encoding.
    device: where the store lives: the card unless the caller asks for the
        CPU.
    quantize_uint8: store float images as uint8 (default); False keeps
        float32 (exact, 4× the bytes).
    columns: keep only these columns (e.g. one modality).
    """

    def __init__(
        self,
        dataset,
        cfg,
        mesh=None,
        quantize_uint8: bool = True,
        columns: Optional[Tuple[str, ...]] = None,
        shard_rows: Optional[bool] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        if mesh is not None or shard_rows:
            raise NotImplementedError("a sharded DeviceStore (mesh, shard_rows) is not ported")
        self.cfg = cfg
        self.device = torch.device(device)
        self._quantize_uint8 = quantize_uint8
        self.labels = np.asarray(dataset.labels)
        cols = dataset.arrays
        if columns is not None:
            cols = {k: v for k, v in cols.items() if k in columns}
        idx_all = np.arange(len(dataset))
        with profiling.span("store.build", rows=len(dataset)) as build:
            with profiling.span("store.fetch"):
                host = {k: self._fetch(col, k, idx_all) for k, col in cols.items()}
            self.nbytes = build.attrs["bytes"] = sum(a.nbytes for a in host.values())
            with profiling.span("store.upload"):
                self._cols = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}
        log.info(f"DeviceStore: {len(dataset)} samples, {self.nbytes / 1e9:.2f} GB on "
                 f"{self.device}")

    # ------------------------------------------------------------------

    def _fetch(self, col, k: str, idx: np.ndarray) -> np.ndarray:
        """Host rows in the store's compact form; images NCHW."""
        if k == "text":
            return self._compact_text(col, idx)
        arr = np.ascontiguousarray(col[idx])
        if self._quantize_uint8:
            arr = _compact_images(arr)
        elif arr.dtype == np.uint8:
            # uint8 source in the float path: dequantised here, since the
            # gather dequantises only uint8 columns
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = np.asarray(arr, np.float32)
        return np.ascontiguousarray(arr.transpose(0, 3, 1, 2))

    def _compact_text(self, col, idx) -> np.ndarray:
        """Text column → id array ([N, L] int32 word ids / uint8 char ids)."""
        if self.cfg.text_encoding == "word":
            return np.asarray(col[idx], np.int32)
        # char: argmax of the one-hot column, the exact inverse for genuine
        # one-hots; non-one-hot float fixtures degrade to argmax
        onehot = np.asarray(col[idx])
        if onehot.shape[-1] != len(ALPHABET):
            raise ValueError(f"char text column of width {onehot.shape[-1]}, not {len(ALPHABET)}")
        return np.argmax(onehot, axis=-1).astype(np.uint8)

    def gather_fn(self, cols: Dict[str, torch.Tensor], idx: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
        """(columns, index vector on their device) → the model-ready batch:
        float images, int32 word ids or a float one-hot of char ids."""
        batch = {}
        for k, col in cols.items():
            rows = col.index_select(0, idx)
            if k == "text":
                if self.cfg.text_encoding == "char":
                    rows = torch.nn.functional.one_hot(rows.long(), len(ALPHABET)).float()
            elif rows.dtype == torch.uint8:
                rows = rows.float() * (1.0 / 255.0)  # float32(1/255): the JAX store's
            batch[k] = rows
        return batch

    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def cols(self) -> Dict[str, torch.Tensor]:
        """The device-resident columns (images [N, C, H, W])."""
        return self._cols

    def gather(self, idx) -> Dict[str, torch.Tensor]:
        """Index vector (numpy, or a tensor on the store's device) → batch."""
        if not isinstance(idx, torch.Tensor):
            idx = torch.from_numpy(np.asarray(idx, np.int32))
        return self.gather_fn(self._cols, idx.to(self.device))

    def epoch_order(self, epoch: int, shuffle: bool = True, seed: int = 0,
                    weighted: bool = False) -> np.ndarray:
        """The epoch's global sample order: the same draw ``iter_epoch`` and
        ``train/scan.epoch_index_matrix`` make."""
        n = len(self)
        rng = np.random.default_rng((seed, epoch))
        if weighted:
            return rng.choice(n, size=n, replace=True, p=self._label_weights())
        if shuffle:
            return rng.permutation(n)
        return np.arange(n)

    def iter_epoch(
        self,
        epoch: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        weighted: bool = False,
    ) -> Iterator[Tuple[Dict[str, torch.Tensor], np.ndarray]]:
        """Yields (device batch, host labels) like ``BatchLoader``; the only
        per-step upload is the [B] index vector. ``weighted`` draws the order
        with replacement by inverse label-combination frequency."""
        n = len(self)
        order = self.epoch_order(epoch, shuffle=shuffle, seed=seed, weighted=weighted)
        nb = n // batch_size if drop_last else -(-n // batch_size)
        if nb == 0 and n > 0:
            # a static batch shape: one wraparound-padded batch (repeated
            # rows) instead of an empty epoch
            log.warning(f"DeviceStore.iter_epoch: split has {n} rows < batch_size "
                        f"{batch_size}; yielding one wraparound-padded batch")
            idx = np.resize(order, batch_size)
            yield self.gather(idx), self.labels[idx]
            return
        for b in range(nb):
            idx = order[b * batch_size : (b + 1) * batch_size]
            yield self.gather(idx), self.labels[idx]

    def _label_weights(self) -> np.ndarray:
        if getattr(self, "_weights", None) is None:
            self._weights = BatchLoader._label_weights(self.labels)
        return self._weights

    # ------------------------------------------------------------------

    @staticmethod
    def fits(dataset, cfg, budget_bytes: Optional[int] = None,
             device: Union[str, torch.device] = "cuda") -> bool:
        """The compact store's bytes against ``budget_bytes``, by default the
        free memory of the card (``torch.cuda.mem_get_info``)."""
        if budget_bytes is None:
            budget_bytes = torch.cuda.mem_get_info(torch.device(device))[0]
        per = 0
        sample, _ = dataset[0]
        for k, v in sample.items():
            v = np.asarray(v)
            if k == "text":
                per += v.shape[0] * (4 if cfg.text_encoding == "word" else 1)
            else:
                per += int(np.prod(v.shape))  # uint8
        return len(dataset) * per <= budget_bytes
