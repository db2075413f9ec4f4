"""K1: the all-subsets product of experts as hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``_fusion_kernel``
(mopoe_mimic_tpu/ops/pallas_fusion.py:42) and the XLA VJP that serves as
its gradient (pallas_fusion.py:83-92). The kernels are
``csrc/poe_subsets.cu``: ``poe_subsets_f32`` (forward) and
``poe_subsets_bwd_f32`` (backward), joined by a ``torch.autograd.Function``.
Their plain PyTorch versions are ``ops/fusion.poe_subsets`` and
``ops/fusion.poe_subsets_bwd``.

The experts are read where they lie: M [B, D] tensors (or the M slices of
a stacked [M, B, D] pair), each with unit stride along D and its own row
stride, passed to the kernels as pointers (``_build.Experts``). The power
set of M <= 3 experts in ``subset_powerset`` order, the layout the model
uses, runs kernels built for it at compile time; any other mask runs the
generic kernels. Every kernel takes one element a thread in blocks of 128
threads (csrc/poe_subsets.cu's POE_THREADS: the fastest of a sweep, PERF.md).

The kernels take microseconds; the host's work around a launch is what a
call costs. So the wrapper does no repeated work: a mask's kernel view is
built once per (mask contents, experts) and cached (``kernel_layout``), the
current device is entered only when it is not the tensors' own, and a
forward that needs no gradient skips ``autograd.Function.apply``. Every
check still runs on every call. The backward reads the experts' addresses
from the tensors that autograd gives back, not from the forward's call: a
saved-tensor hook (checkpointing, ``save_on_cpu``) gives back new tensors.
"""

from __future__ import annotations

import functools
import struct
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.ops.fusion import prior_precision, subset_mask_matrix, subset_members

# Launches of each kernel since the last reset, each replay of a captured
# graph counted as the launches it holds (train/scan.py); read by
# chip_smoke.py to show that the main path went through the kernels.
LAUNCHES = _build.launch_counts("poe_subsets_f32", "poe_subsets_bwd_f32")

POWERSET_MAX_EXPERTS = 3  # csrc/poe_subsets.cu's POE_POWERSET_MAX_EXPERTS

Experts = Union[torch.Tensor, Sequence[torch.Tensor]]

_EXPERTS = struct.Struct(f"{2 * _build.MAX_EXPERTS}Q{2 * _build.MAX_EXPERTS}q")
_PAD = [(0,) * (_build.MAX_EXPERTS - m) for m in range(_build.MAX_EXPERTS + 1)]


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


def _key(subset_mask: np.ndarray) -> Tuple[str, Tuple[int, ...], bytes]:
    mask = np.ascontiguousarray(subset_mask)
    return mask.dtype.str, mask.shape, mask.tobytes()


def subset_masks(subset_mask: np.ndarray, n_experts: int) -> _build.SubsetMasks:
    """``_masks``, built once per (mask contents, ``n_experts``): keyed by
    the mask's dtype, shape and bytes, so equal masks share one entry
    whatever array holds them. The generic kernels take it."""
    return _cached_masks(*_key(subset_mask), n_experts)


def powerset_members(n_experts: int) -> Tuple[int, ...]:
    """Member bitmasks of the rows of ``subset_mask_matrix`` of
    ``n_experts`` modalities: the layout the power-set kernels are built for
    (csrc/poe_subsets.cu's ``powerset_row``)."""
    names = tuple(f"m{i}" for i in range(n_experts))
    return tuple(sum(1 << m for m in members)
                 for members in subset_members(subset_mask_matrix(names)))


class KernelLayout(NamedTuple):
    """A mask as the kernels take it: ``masks`` None for the power set of
    M <= 3 experts (compile-time members), else the member bitmasks for the
    generic kernels; ``n_subsets`` = S."""

    masks: Optional[_build.SubsetMasks]
    n_subsets: int


@functools.lru_cache(maxsize=64)
def _cached_layout(dtype: str, shape: Tuple[int, ...], data: bytes,
                   n_experts: int) -> KernelLayout:
    masks = _cached_masks(dtype, shape, data, n_experts)
    rows = tuple(masks.members[:masks.n_subsets])
    powerset = n_experts <= POWERSET_MAX_EXPERTS and rows == powerset_members(n_experts)
    return KernelLayout(None if powerset else masks, masks.n_subsets)


def kernel_layout(subset_mask: np.ndarray, n_experts: int) -> KernelLayout:
    """The kernels' view of ``subset_mask`` [S, M], built once per (mask
    contents, ``n_experts``) as ``subset_masks`` is: the power-set kernels
    only where the mask equals that layout row for row."""
    return _cached_layout(*_key(subset_mask), n_experts)


class _Call(NamedTuple):
    """One call's arguments as the kernels take them."""

    experts: _build.Experts
    n_experts: int
    batch: int
    dim: int
    device: torch.device
    layout: KernelLayout
    prior: bool
    prior_t: float
    stacked: bool  # the experts came as one [M, B, D] pair
    requires_grad: bool  # an expert records gradients


class _Pointers(NamedTuple):
    """The experts' addresses and what a call reads of the tensors."""

    experts: _build.Experts
    shape: Tuple[int, int, int]  # M, B, D
    device: torch.device
    requires_grad: bool


def _experts(ptrs: Sequence[int], rows: Sequence[int]) -> _build.Experts:
    """The kernels' ``Experts`` from the M mu then M logvar addresses and
    their row strides (in floats)."""
    m = len(ptrs) // 2
    pad = _PAD[m]
    return _build.Experts.from_buffer_copy(_EXPERTS.pack(
        *ptrs[:m], *pad, *ptrs[m:], *pad, *rows[:m], *pad, *rows[m:], *pad))


def _refuse(name: str, x: torch.Tensor, ndim: int, device: Optional[torch.device] = None,
            shape=None) -> None:
    """Raise for what the kernels do not take: a tensor off the card or on
    another device than the experts', not float32, of another rank or shape
    than the experts', or strided along D."""
    if not x.is_cuda:
        raise ValueError(f"poe_subsets_cuda: {name} is on {x.device}, not a CUDA device")
    if x.dtype != torch.float32:
        raise TypeError(f"poe_subsets_cuda: {name} is {x.dtype}; the kernel takes float32")
    if x.dim() != ndim:
        raise ValueError(f"poe_subsets_cuda: {name} must be [M, B, D] or M tensors [B, D], "
                         f"got {tuple(x.shape)}")
    if device is not None and x.device != device:
        raise ValueError(f"poe_subsets_cuda: {name} is on {x.device}, the experts on {device}")
    if shape is not None and x.shape != shape:
        raise ValueError(f"poe_subsets_cuda: {name} is {tuple(x.shape)}, not {tuple(shape)}")
    raise ValueError(f"poe_subsets_cuda: {name} is not contiguous along D "
                     f"(shape {tuple(x.shape)}, strides {x.stride()})")


def _n_experts(n_experts: int) -> None:
    if not 1 <= n_experts <= _build.MAX_EXPERTS:
        raise ValueError(f"{n_experts} experts; the kernel takes 1..{_build.MAX_EXPERTS}")


def _stacked_pointers(mus: torch.Tensor, logvars: torch.Tensor) -> _Pointers:
    """A stacked pair [M, B, D], checked: the addresses of its M slices."""
    for name, x in (("mus", mus), ("logvars", logvars)):
        if not (x.is_cuda and x.dtype == torch.float32 and x.dim() == 3 and x.stride(2) == 1):
            _refuse(name, x, 3)
    if logvars.shape != mus.shape or logvars.device != mus.device:
        raise ValueError("poe_subsets_cuda: mus and logvars differ in shape or device")
    n_experts = mus.shape[0]
    _n_experts(n_experts)
    mu0, lv0 = mus.data_ptr(), logvars.data_ptr()
    (mu_m, mu_row, _), (lv_m, lv_row, _) = mus.stride(), logvars.stride()
    experts = _experts([mu0 + 4 * mu_m * m for m in range(n_experts)]
                       + [lv0 + 4 * lv_m * m for m in range(n_experts)],
                       [mu_row] * n_experts + [lv_row] * n_experts)
    return _Pointers(experts, tuple(mus.shape), mus.device,
                     mus.requires_grad or logvars.requires_grad)


def _sequence_pointers(mus: Sequence[torch.Tensor],
                       logvars: Sequence[torch.Tensor]) -> _Pointers:
    """M tensors [B, D] each for mus and logvars, checked: their addresses."""
    n_experts = len(mus)
    if len(logvars) != n_experts:
        raise ValueError(f"poe_subsets_cuda: {n_experts} mus and {len(logvars)} logvars")
    _n_experts(n_experts)
    first = mus[0]
    device, shape, index = first.device, first.shape, first.get_device()
    if index < 0 or len(shape) != 2:
        _refuse("mus", first, 2)
    f32 = torch.float32
    ptrs, rows = [], []
    grad = False
    for name, seq in (("mus", mus), ("logvars", logvars)):
        for x in seq:
            stride = x.stride()
            if (x.dtype is not f32 or x.get_device() != index or x.shape != shape
                    or stride[1] != 1):
                _refuse(name, x, 2, device, shape)
            ptrs.append(x.data_ptr())
            rows.append(stride[0])
            grad = grad or x.requires_grad
    return _Pointers(_experts(ptrs, rows), (n_experts, *shape), device, grad)


def _pointers(mus: Experts, logvars: Experts) -> Tuple[_Pointers, bool]:
    """The experts' ``_Pointers``, and whether they came as a stacked pair."""
    if isinstance(mus, torch.Tensor) and isinstance(logvars, torch.Tensor):
        return _stacked_pointers(mus, logvars), True
    if isinstance(mus, torch.Tensor) or isinstance(logvars, torch.Tensor):
        raise TypeError("poe_subsets_cuda: mus and logvars must both be [M, B, D] tensors or "
                        "both sequences of [B, D] tensors")
    return _sequence_pointers(mus, logvars), False


def _call(mus: Experts, logvars: Experts, subset_mask: np.ndarray, prior_expert: bool) -> _Call:
    (experts, (n_experts, batch, dim), device, grad), stacked = _pointers(mus, logvars)
    return _Call(experts, n_experts, batch, dim, device, kernel_layout(subset_mask, n_experts),
                 prior_expert, prior_precision(prior_expert), stacked, grad)


def _poe_subsets_fwd(call: _Call) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poe_subsets_f32``: mu, logvar [S, B, D] of the call's experts."""
    mu_out = torch.empty((call.layout.n_subsets, call.batch, call.dim), device=call.device)
    lv_out = torch.empty_like(mu_out)
    with _build.on_device(call.device):
        _build.launch(LAUNCHES, "poe_subsets_f32", call.experts, mu_out.data_ptr(),
                      lv_out.data_ptr(), call.n_experts, call.batch, call.dim, call.layout.masks,
                      call.prior, call.prior_t)
    return mu_out, lv_out


def _poe_subsets_bwd(call: _Call, dmu_s: torch.Tensor,
                     dlv_s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poe_subsets_bwd_f32``: dmu, dlv [M, B, D] (slice m is expert m's
    gradient) from the upstream gradients [S, B, D]."""
    dmu_s = dmu_s.float().contiguous()
    dlv_s = dlv_s.float().contiguous()
    dmu = torch.empty((call.n_experts, call.batch, call.dim), device=call.device)
    dlv = torch.empty_like(dmu)
    with _build.on_device(call.device):
        _build.launch(LAUNCHES, "poe_subsets_bwd_f32", call.experts, dmu_s.data_ptr(),
                      dlv_s.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), call.n_experts,
                      call.batch, call.dim, call.layout.masks, call.prior, call.prior_t)
    return dmu, dlv


class _PoeSubsets(torch.autograd.Function):
    """Forward: ``poe_subsets_f32``; backward: ``poe_subsets_bwd_f32``,
    recomputing from the saved experts, which are kept without a copy and
    read where autograd gives them back. The gradients are slices of one
    [M, B, D] buffer per input (the buffer itself for a stacked pair)."""

    @staticmethod
    def forward(ctx, call, *experts):
        mu_out, lv_out = _poe_subsets_fwd(call)
        ctx.save_for_backward(*experts)
        ctx.call = call
        return mu_out, lv_out

    @staticmethod
    def backward(ctx, dmu_s, dlv_s):
        # raises if an expert was changed in place since the forward; under a
        # saved-tensor hook these are new tensors, so their addresses are read
        saved, call = ctx.saved_tensors, ctx.call
        m = len(saved) // 2
        again, _ = _pointers(*saved) if call.stacked else _pointers(saved[:m], saved[m:])
        if again.shape != (call.n_experts, call.batch, call.dim) or again.device != call.device:
            raise RuntimeError(f"poe_subsets_cuda: the saved experts came back as {again.shape} "
                               f"on {again.device}")
        dmu, dlv = _poe_subsets_bwd(call._replace(experts=again.experts), dmu_s, dlv_s)
        if call.stacked:
            return None, dmu, dlv
        return (None, *dmu.unbind(0), *dlv.unbind(0))


def poe_subsets_bwd_cuda(mus: Experts, logvars: Experts, dmu_s: torch.Tensor,
                         dlv_s: torch.Tensor, subset_mask: np.ndarray,
                         prior_expert: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``poe_subsets_bwd_f32`` on its own: dmu, dlv [M, B, D] from the
    experts (as ``poe_subsets_cuda`` takes them) and the upstream
    gradients [S, B, D] (float32, on the experts' device)."""
    call = _call(mus, logvars, subset_mask, prior_expert)
    for name, x in (("dmu_s", dmu_s), ("dlv_s", dlv_s)):
        if x.shape != (call.layout.n_subsets, call.batch, call.dim) or x.device != call.device:
            raise ValueError(f"poe_subsets_bwd_cuda: {name} is {tuple(x.shape)} on {x.device}")
    return _poe_subsets_bwd(call, dmu_s, dlv_s)


def poe_subsets_cuda(
    mus: Experts,
    logvars: Experts,
    subset_mask: np.ndarray,
    prior_expert: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on M experts, float32 on one CUDA device: ``mus`` and ``logvars``
    each M tensors [B, D] with unit stride along D (read in place), or a
    stacked pair [M, B, D] (its slices). Returns mu, logvar [S, B, D];
    differentiable through the backward kernel where grad mode is on and an
    input requires grad."""
    call = _call(mus, logvars, subset_mask, prior_expert)
    if call.requires_grad and torch.is_grad_enabled():
        return _PoeSubsets.apply(call, *((mus, logvars) if call.stacked else (*mus, *logvars)))
    return _poe_subsets_fwd(call)
