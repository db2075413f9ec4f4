"""Epoch-level metric aggregation (mopoe_mimic_tpu/utils/meters.py).

The per-step loop adds each step's metric tree into sums on the device and
reads them once an epoch (``fetch_scalar_tree``: the leaves stacked into one
float64 vector on the device, one copy to the host), so no step waits for
the card. Means are true means (the reference's scalar AverageMeter returns
the last value, average_meters.py:33-34, a bug not reproduced).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten


def fetch_scalar_tree(tree: Any) -> Any:
    """A tree of scalar tensors → the same tree of floats, in one read of
    the device."""
    leaves, spec = tree_flatten(tree)
    flat = torch.stack([x.detach().to(torch.float64) for x in leaves]).tolist() if leaves else []
    return tree_unflatten(flat, spec)


class MetricAccumulator:
    """Sums metric trees of tensors on the device; the means on read."""

    def __init__(self):
        self._sum: Optional[Any] = None
        self._count: int = 0

    def update(self, metrics: Any) -> None:
        if self._sum is None:
            self._sum = tree_map(lambda x: x.detach().to(torch.float64), metrics)
        else:
            self._sum = tree_map(lambda a, b: a + b.detach(), self._sum, metrics)
        self._count += 1

    def averages(self) -> Any:
        """The epoch's means as a tree of floats: one read of the device."""
        if self._sum is None:
            return {}
        return tree_map(lambda a: a / self._count, fetch_scalar_tree(self._sum))

    @property
    def count(self) -> int:
        return self._count


def flatten_metrics(d: Any, prefix: str = "", sep: str = "/") -> Dict[str, float]:
    """Nested metrics tree → flat {name: float} for the TensorBoard and CSV
    sinks (mimic/utils/utils.py:240-248)."""
    out: Dict[str, float] = {}

    def rec(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, f"{name}{sep}{k}" if name else str(k))
        elif isinstance(node, (tuple, list)):
            for i, v in enumerate(node):
                rec(v, f"{name}{sep}{i}")
        elif node is None:
            return
        elif isinstance(node, str):
            out[name] = node  # labels and modality names pass through to the CSV
        else:
            if isinstance(node, torch.Tensor):
                node = node.detach().cpu().numpy()
            arr = np.asarray(node)
            if arr.ndim == 0:
                out[name] = float(arr)
            else:
                for i, v in enumerate(arr.ravel()):
                    out[f"{name}{sep}{i}"] = float(v)

    rec(d, prefix)
    return out
