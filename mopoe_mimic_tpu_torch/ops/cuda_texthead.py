"""K2: the fused word-text vocab head as hand-written CUDA kernels.

Replaces the Pallas TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` of
``mopoe_mimic_tpu/ops/pallas_texthead.py`` (:72, :88). The kernels are
``csrc/texthead.cu``: ``texthead_fwd`` (lp and lse), and for the backward
``texthead_bwd_dh`` (dh) and ``texthead_bwd_dw`` (dW, db), joined by a
``torch.autograd.Function`` that saves only lse. Their plain PyTorch
versions are ``ops/texthead.texthead_fwd_plain`` and
``texthead_bwd_plain``.

In bfloat16 the forward and the backward run on tensor cores (the
forward with an online logsumexp, the logits never in memory), and
``texthead_bwd_dw`` splits the rows across blocks: it writes each split's
partial dW and db, and ``texthead_bwd_dw_finalize`` sums them in a fixed
order. In float32 all three run on the CUDA cores and ``texthead_bwd_dw``
writes dW and db itself. A bfloat16 kernel must start 4-byte aligned:
there is no other path to fall back to.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from mopoe_mimic_tpu_torch.ops import _build

# Launches of each kernel since the last reset, each replay of a captured
# graph counted as the launches it holds (train/scan.py); read by
# chip_smoke.py to show that the main path went through the kernels.
LAUNCHES = _build.launch_counts("texthead_fwd", "texthead_bwd_dh", "texthead_bwd_dw",
                                  "texthead_bwd_dw_finalize")

MAX_CHANNELS = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
           targets: torch.Tensor) -> None:
    for name, x in (("h", h), ("kernel", kernel), ("bias", bias), ("targets", targets)):
        if not x.is_cuda:
            raise ValueError(f"texthead_cuda: {name} is on {x.device}, not a CUDA device")
        if x.device != h.device:
            raise ValueError(f"texthead_cuda: {name} is on {x.device}, h on {h.device}")
        if not x.is_contiguous():
            raise ValueError(f"texthead_cuda: {name} is not contiguous")
    if h.dtype not in _DTYPE_CODE or kernel.dtype != h.dtype:
        raise TypeError(f"texthead_cuda: h {h.dtype} and kernel {kernel.dtype} must both be "
                        "float32 or both bfloat16")
    if h.dtype == torch.bfloat16 and kernel.data_ptr() % 4:
        raise ValueError("texthead_cuda: a bfloat16 kernel must start 4-byte aligned")
    if bias.dtype != torch.float32:
        raise TypeError(f"texthead_cuda: bias is {bias.dtype}; the kernels take float32")
    if h.dim() != 2 or kernel.dim() != 2 or bias.dim() != 1 or targets.dim() != 1:
        raise ValueError("texthead_cuda: h [R, C], kernel [C, V], bias [V], targets [R]")
    (R, C), V = h.shape, kernel.shape[1]
    if kernel.shape[0] != C or bias.shape[0] != V or targets.shape[0] != R:
        raise ValueError(f"texthead_cuda: shapes h {tuple(h.shape)}, kernel "
                         f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}, targets "
                         f"{tuple(targets.shape)} do not agree")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"texthead_cuda: {C} channels; the kernels take 1..{MAX_CHANNELS}")


def texthead_fwd_cuda(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      targets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``texthead_fwd``: (lp, lse) [R] float32; inputs as ``texthead_cuda``
    takes them, targets int32."""
    (R, C), V = h.shape, kernel.shape[1]
    lp = h.new_empty((R,), dtype=torch.float32)
    lse = torch.empty_like(lp)
    with _build.on_device(h.device):
        _build.launch(LAUNCHES, "texthead_fwd", h.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                      targets.data_ptr(), lp.data_ptr(), lse.data_ptr(), R, C, V,
                      _DTYPE_CODE[h.dtype])
    return lp, lse


def texthead_bwd_dh_cuda(h, kernel, bias, targets, lse, g) -> torch.Tensor:
    """``texthead_bwd_dh``: dh [R, C] in h's dtype; g [R] float32."""
    (R, C), V = h.shape, kernel.shape[1]
    dh = torch.empty_like(h)
    with _build.on_device(h.device):
        _build.launch(LAUNCHES, "texthead_bwd_dh", h.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                      targets.data_ptr(), lse.data_ptr(), g.data_ptr(), dh.data_ptr(), R, C, V,
                      _DTYPE_CODE[h.dtype])
    return dh


@functools.lru_cache(maxsize=None)
def _dw_splits(device_index: int, R: int, C: int, V: int) -> int:
    """Row splits of bfloat16 ``texthead_bwd_dw`` on the current device
    (``device_index`` keys the cache)."""
    splits = _build.load_library().texthead_bwd_dw_splits(R, C, V)
    if splits < 1:
        raise RuntimeError(f"texthead_bwd_dw_splits failed: cudaError {-splits}")
    return splits


def texthead_bwd_dw_partials_cuda(h, kernel, bias, targets, lse, g
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``texthead_bwd_dw`` on bfloat16 inputs: the partial sums of its row
    splits, dW [splits, C, V] and db [splits, V], float32."""
    (R, C), V = h.shape, kernel.shape[1]
    with _build.on_device(h.device):
        splits = _dw_splits(h.device.index, R, C, V)
        part_dw = torch.empty((splits, C, V), dtype=torch.float32, device=h.device)
        part_db = torch.empty((splits, V), dtype=torch.float32, device=h.device)
        _build.launch(LAUNCHES, "texthead_bwd_dw", h.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                      targets.data_ptr(), lse.data_ptr(), g.data_ptr(), part_dw.data_ptr(),
                      part_db.data_ptr(), R, C, V, splits, _DTYPE_CODE[h.dtype])
    return part_dw, part_db


def texthead_bwd_dw_finalize_cuda(part_dw: torch.Tensor, part_db: torch.Tensor
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``texthead_bwd_dw_finalize``: dW [C, V] and db [V], the partials
    summed over their splits in order."""
    splits, C, V = part_dw.shape
    dw = part_dw.new_empty((C, V))
    db = part_db.new_empty((V,))
    with _build.on_device(part_dw.device):
        _build.launch(LAUNCHES, "texthead_bwd_dw_finalize", part_dw.data_ptr(), part_db.data_ptr(),
                      dw.data_ptr(), db.data_ptr(), splits, C, V)
    return dw, db


def texthead_bwd_dw_cuda(h, kernel, bias, targets, lse, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """dW [C, V] and db [V], float32; g [R] float32. bfloat16: the
    tensor-core partials, then their finalize; float32: ``texthead_bwd_dw``
    alone."""
    if h.dtype == torch.bfloat16:
        return texthead_bwd_dw_finalize_cuda(
            *texthead_bwd_dw_partials_cuda(h, kernel, bias, targets, lse, g))
    (R, C), V = h.shape, kernel.shape[1]
    dw = torch.empty((C, V), dtype=torch.float32, device=h.device)
    db = torch.empty((V,), dtype=torch.float32, device=h.device)
    with _build.on_device(h.device):
        _build.launch(LAUNCHES, "texthead_bwd_dw", h.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
                      targets.data_ptr(), lse.data_ptr(), g.data_ptr(), dw.data_ptr(),
                      db.data_ptr(), R, C, V, 1, _DTYPE_CODE[h.dtype])
    return dw, db


class _CudaTextHead(torch.autograd.Function):
    """Forward ``texthead_fwd``; backward ``texthead_bwd_dh`` and
    ``texthead_bwd_dw``, recomputing the logits from the saved lse."""

    @staticmethod
    def forward(ctx, h, kernel, bias, targets):
        lp, lse = texthead_fwd_cuda(h, kernel, bias, targets)
        ctx.save_for_backward(h, kernel, bias, targets, lse)
        return lp

    @staticmethod
    def backward(ctx, g):
        h, kernel, bias, targets, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dh = texthead_bwd_dh_cuda(h, kernel, bias, targets, lse, g)
        dw, db = texthead_bwd_dw_cuda(h, kernel, bias, targets, lse, g)
        return dh, dw.to(kernel.dtype), db, None


def texthead_cuda(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """K2 on h [R, C] and kernel [C, V] (both float32 or both bfloat16,
    contiguous), bias [V] float32 and targets [R] on one CUDA device.
    Returns lp [R] float32; differentiable in h, kernel and bias through the
    backward kernels."""
    targets = targets.to(torch.int32).contiguous()
    _check(h, kernel, bias, targets)
    return _CudaTextHead.apply(h, kernel, bias, targets)
