"""K1: the all-subsets product of experts as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel ``_fusion_kernel``
(mopoe_mimic_tpu/ops/pallas_fusion.py:42) on the serving path; the
kernel is ``csrc/poe_subsets.cu``, its plain PyTorch version is
``ops/fusion.poe_subsets``. Forward only: the wrapper refuses inputs that
require grad, since the backward kernel comes with the training port.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.ops.fusion import prior_precision, subset_members

# Launches of the kernel since the last reset; read by chip_smoke.py to show
# that the main path went through the kernel.
LAUNCHES = 0


def _masks(subset_mask: np.ndarray, n_experts: int) -> _build.SubsetMasks:
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


def poe_subsets_cuda(
    mus: torch.Tensor,
    logvars: torch.Tensor,
    subset_mask: np.ndarray,
    prior_expert: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on mus, logvars [M, B, D] (f32, contiguous, one CUDA
    device, no grad). Returns mu, logvar [S, B, D]."""
    global LAUNCHES
    for name, x in (("mus", mus), ("logvars", logvars)):
        if not x.is_cuda:
            raise ValueError(f"poe_subsets_cuda: {name} is on {x.device}, not a CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"poe_subsets_cuda: {name} is {x.dtype}; the kernel takes float32")
        if not x.is_contiguous():
            raise ValueError(f"poe_subsets_cuda: {name} is not contiguous")
        if x.requires_grad:
            raise ValueError(f"poe_subsets_cuda: {name} requires grad; the kernel has no backward")
        if x.dim() != 3:
            raise ValueError(f"poe_subsets_cuda: {name} must be [M, B, D], got {tuple(x.shape)}")
    if mus.shape != logvars.shape or mus.device != logvars.device:
        raise ValueError("poe_subsets_cuda: mus and logvars differ in shape or device")
    n_experts, batch, dim = mus.shape
    if not 1 <= n_experts <= _build.MAX_EXPERTS:
        raise ValueError(f"{n_experts} experts; the kernel takes 1..{_build.MAX_EXPERTS}")
    masks = _masks(subset_mask, n_experts)

    lib = _build.load_library()
    mu_out = torch.empty((masks.n_subsets, batch, dim), dtype=torch.float32, device=mus.device)
    lv_out = torch.empty_like(mu_out)
    with torch.cuda.device(mus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.poe_subsets_f32(
            mus.data_ptr(), logvars.data_ptr(), mu_out.data_ptr(), lv_out.data_ptr(),
            n_experts, batch, dim, masks, prior_precision(prior_expert), stream,
        )
    if err != 0:
        raise RuntimeError(f"poe_subsets_f32 launch failed: cudaError {err}")
    LAUNCHES += 1
    return mu_out, lv_out
