"""K1: the all-subsets product of experts as hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``_fusion_kernel``
(mopoe_mimic_tpu/ops/pallas_fusion.py:42) and the XLA VJP that serves as
its gradient (pallas_fusion.py:86-92). The kernels are
``csrc/poe_subsets.cu``: ``poe_subsets_f32`` (forward) and
``poe_subsets_bwd_f32`` (backward), joined by a ``torch.autograd.Function``.
Their plain PyTorch versions are ``ops/fusion.poe_subsets`` and
``ops/fusion.poe_subsets_bwd``.

The kernels take microseconds; the host's work around a launch is what a
call costs. So the wrapper does no repeated work: the ``SubsetMasks`` of a
mask is built once per (mask contents, experts) and cached
(``subset_masks``), the current device is entered only when it is not the
tensors' own, and a forward that needs no gradient skips
``autograd.Function.apply``. Every check still runs on every call.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.ops.fusion import prior_precision, subset_members

# Launches of each kernel since the last reset; read by chip_smoke.py to
# show that the main path went through the kernels.
LAUNCHES = {"poe_subsets_f32": 0, "poe_subsets_bwd_f32": 0}


def _masks(subset_mask: np.ndarray, n_experts: int) -> _build.SubsetMasks:
    """The kernels' member bitmasks of ``subset_mask`` [S, M], built anew."""
    rows = subset_members(subset_mask)
    if np.asarray(subset_mask).shape[1] != n_experts:
        raise ValueError(
            f"subset_mask has {np.asarray(subset_mask).shape[1]} columns for {n_experts} experts")
    if not 1 <= len(rows) <= _build.MAX_SUBSETS:
        raise ValueError(f"{len(rows)} subsets; the kernel takes 1..{_build.MAX_SUBSETS}")
    masks = _build.SubsetMasks()
    masks.n_subsets = len(rows)
    for s, members in enumerate(rows):
        masks.members[s] = sum(1 << m for m in members)
    return masks


@functools.lru_cache(maxsize=64)
def _cached_masks(dtype: str, shape: Tuple[int, ...], data: bytes,
                  n_experts: int) -> _build.SubsetMasks:
    mask = np.frombuffer(data, dtype=np.dtype(dtype)).reshape(shape)
    return _masks(mask, n_experts)


def subset_masks(subset_mask: np.ndarray, n_experts: int) -> _build.SubsetMasks:
    """``_masks``, built once per (mask contents, ``n_experts``): keyed by
    the mask's dtype, shape and bytes, so equal masks share one entry
    whatever array holds them. The kernels take it by value."""
    mask = np.ascontiguousarray(subset_mask)
    return _cached_masks(mask.dtype.str, mask.shape, mask.tobytes(), n_experts)


def _check(name: str, x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"poe_subsets_cuda: {name} is on {x.device}, not a CUDA device")
    if x.dtype != torch.float32:
        raise TypeError(f"poe_subsets_cuda: {name} is {x.dtype}; the kernel takes float32")
    if not x.is_contiguous():
        raise ValueError(f"poe_subsets_cuda: {name} is not contiguous")
    if x.dim() != 3:
        raise ValueError(f"poe_subsets_cuda: {name} must be [M, B, D], got {tuple(x.shape)}")


def _poe_subsets_fwd(mus, logvars, masks: _build.SubsetMasks,
                     prior_t: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poe_subsets_f32``: mu, logvar [S, B, D] from mus, logvars [M, B, D]."""
    n_experts, batch, dim = mus.shape
    mu_out = mus.new_empty((masks.n_subsets, batch, dim))
    lv_out = torch.empty_like(mu_out)
    with _build.on_device(mus.device):
        _build.launch(LAUNCHES, "poe_subsets_f32", mus.data_ptr(), logvars.data_ptr(),
                      mu_out.data_ptr(), lv_out.data_ptr(), n_experts, batch, dim, masks, prior_t)
    return mu_out, lv_out


class _PoeSubsets(torch.autograd.Function):
    """Forward: ``poe_subsets_f32``; backward: ``poe_subsets_bwd_f32``,
    recomputing from the saved inputs (mus, logvars)."""

    @staticmethod
    def forward(ctx, mus, logvars, masks, prior_t):
        mu_out, lv_out = _poe_subsets_fwd(mus, logvars, masks, prior_t)
        ctx.save_for_backward(mus, logvars)
        ctx.masks, ctx.prior_t = masks, prior_t
        return mu_out, lv_out

    @staticmethod
    def backward(ctx, dmu_s, dlv_s):
        mus, logvars = ctx.saved_tensors
        dmu, dlv = poe_subsets_bwd_cuda(mus, logvars, dmu_s.float().contiguous(),
                                        dlv_s.float().contiguous(), ctx.masks, ctx.prior_t)
        return dmu, dlv, None, None


def poe_subsets_bwd_cuda(mus, logvars, dmu_s, dlv_s, masks: _build.SubsetMasks,
                         prior_t: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poe_subsets_bwd_f32``: dmu, dlv [M, B, D] from the saved inputs
    [M, B, D] and the upstream gradients [S, B, D], all float32 and
    contiguous on one CUDA device."""
    n_experts, batch, dim = mus.shape
    dmu = torch.empty_like(mus)
    dlv = torch.empty_like(mus)
    with _build.on_device(mus.device):
        _build.launch(LAUNCHES, "poe_subsets_bwd_f32", mus.data_ptr(), logvars.data_ptr(),
                      dmu_s.data_ptr(), dlv_s.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), n_experts,
                      batch, dim, masks, prior_t)
    return dmu, dlv


def poe_subsets_cuda(
    mus: torch.Tensor,
    logvars: torch.Tensor,
    subset_mask: np.ndarray,
    prior_expert: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on mus, logvars [M, B, D] (f32, contiguous, one CUDA device).
    Returns mu, logvar [S, B, D]; differentiable through the backward
    kernel where grad mode is on and an input requires grad."""
    _check("mus", mus)
    _check("logvars", logvars)
    if mus.shape != logvars.shape or mus.device != logvars.device:
        raise ValueError("poe_subsets_cuda: mus and logvars differ in shape or device")
    n_experts = mus.shape[0]
    if not 1 <= n_experts <= _build.MAX_EXPERTS:
        raise ValueError(f"{n_experts} experts; the kernel takes 1..{_build.MAX_EXPERTS}")
    masks = subset_masks(subset_mask, n_experts)
    prior_t = prior_precision(prior_expert)
    if torch.is_grad_enabled() and (mus.requires_grad or logvars.requires_grad):
        return _PoeSubsets.apply(mus, logvars, masks, prior_t)
    return _poe_subsets_fwd(mus, logvars, masks, prior_t)
