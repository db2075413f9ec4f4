"""K3: the fused train-mode BN → ReLU → 1×1 conv as hand-written CUDA kernels.

Replaces the Pallas TPU kernels ``_fwd_kernel``, ``_bwd_reduce_kernel`` and
``_bwd_dx_kernel`` of ``mopoe_mimic_tpu/ops/pallas_pointwise.py`` (:81, :88,
:119). The kernels are ``csrc/pointwise.cu``: ``pointwise_fwd`` (y),
``pointwise_bwd_reduce`` (pass A's per-chunk partial sums of dW, dcb, dγ,
dβ), ``pointwise_bwd_finalize`` (those partials summed in a fixed order:
no atomics, so two equal steps give equal gradients) and
``pointwise_bwd_dx`` (pass B), joined by a ``torch.autograd.Function`` that
saves x, not the normalised activations. They index the port's [B, C, S]
layout directly. Their plain PyTorch versions are
``ops/pointwise.pointwise_{fwd,bwd_reduce,bwd_dx}_plain``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mopoe_mimic_tpu_torch.ops import _build

# Launches of each kernel since the last reset; read by chip_smoke.py to
# show that the main path went through the kernels.
LAUNCHES = {"pointwise_fwd": 0, "pointwise_bwd_reduce": 0, "pointwise_bwd_finalize": 0,
            "pointwise_bwd_dx": 0}

MAX_CHANNELS = 2048
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # channels, outputs and rows of pass A's tiles (csrc/pointwise.cu AT)
TARGET_BLOCKS = 4 * 132  # pass A: about four blocks per SM of an H100


def _launch(name: str, *args) -> None:
    lib = _build.load_library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def reduce_chunks(R: int, C: int, Co: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of pass A: enough (chunk, channel tile,
    output tile) blocks to fill the card, each chunk a multiple of TILE
    rows. A function of the shape alone, so the order of the sums is too."""
    tiles = math.ceil(C / TILE) * math.ceil(Co / TILE)
    n = max(1, min(math.ceil(R / TILE), math.ceil(TARGET_BLOCKS / tiles)))
    rows = math.ceil(math.ceil(R / n) / TILE) * TILE
    return rows, math.ceil(R / rows)


def _check(x3, gamma, beta, mean, inv, w, cb) -> None:
    named = (("x", x3), ("gamma", gamma), ("beta", beta), ("mean", mean), ("inv", inv),
             ("weight", w), ("bias", cb))
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"pointwise_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != x3.device:
            raise ValueError(f"pointwise_cuda: {name} is on {t.device}, x on {x3.device}")
        if not t.is_contiguous():
            raise ValueError(f"pointwise_cuda: {name} is not contiguous")
    if x3.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"pointwise_cuda: x {x3.dtype} and weight {w.dtype} must each be "
                        "float32 or bfloat16")
    for name, t in named[1:5] + named[6:]:
        if t.dtype != torch.float32:
            raise TypeError(f"pointwise_cuda: {name} is {t.dtype}; the kernels take float32")
    if x3.dim() != 3 or w.dim() != 2:
        raise ValueError("pointwise_cuda: x [B, C, S] and weight [C, Co]")
    (B, C, S), Co = x3.shape, w.shape[1]
    if w.shape[0] != C or cb.shape != (Co,) or any(t.shape != (C,) for _, t in named[1:5]):
        raise ValueError(f"pointwise_cuda: shapes x {tuple(x3.shape)}, weight {tuple(w.shape)}, "
                         f"bias {tuple(cb.shape)}, gamma/beta/mean/inv {tuple(gamma.shape)} "
                         "do not agree")
    if not (1 <= C <= MAX_CHANNELS and 1 <= Co <= MAX_CHANNELS):
        raise ValueError(f"pointwise_cuda: {C} → {Co} channels; the kernels take "
                         f"1..{MAX_CHANNELS}")
    if not 1 <= B * S < 2**31:
        raise ValueError(f"pointwise_cuda: {B}·{S} rows; the kernels take 1 to 2^31 - 1")


def _args(x3, gamma, beta, mean, inv, w):
    return (x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            w.data_ptr())


def pointwise_fwd_cuda(x3, gamma, beta, mean, inv, w, cb) -> torch.Tensor:
    """``pointwise_fwd``: y [B, Co, S] in w's dtype."""
    (B, C, S), Co = x3.shape, w.shape[1]
    y = torch.empty((B, Co, S), dtype=w.dtype, device=x3.device)
    with torch.cuda.device(x3.device):
        _launch("pointwise_fwd", *_args(x3, gamma, beta, mean, inv, w), cb.data_ptr(),
                y.data_ptr(), B, C, Co, S, _DTYPE_CODE[x3.dtype], _DTYPE_CODE[w.dtype])
    return y


def pointwise_bwd_partials_cuda(x3, gamma, beta, mean, inv, w, dy) -> Tuple[torch.Tensor, ...]:
    """``pointwise_bwd_reduce``: pass A's partial sums per row chunk (and,
    for dγ and dβ, per output tile): part_dw [chunks, C, Co], part_dcb
    [chunks, Co], part_dg and part_db [chunks, Co tiles, C], float32; dy
    [B, Co, S] in w's dtype."""
    (B, C, S), Co = x3.shape, w.shape[1]
    rows, chunks = reduce_chunks(B * S, C, Co)
    o_tiles = math.ceil(Co / TILE)
    f32 = dict(dtype=torch.float32, device=x3.device)
    parts = (torch.empty((chunks, C, Co), **f32), torch.empty((chunks, Co), **f32),
             torch.empty((chunks, o_tiles, C), **f32), torch.empty((chunks, o_tiles, C), **f32))
    with torch.cuda.device(x3.device):
        _launch("pointwise_bwd_reduce", *_args(x3, gamma, beta, mean, inv, w), dy.data_ptr(),
                *(t.data_ptr() for t in parts), B, C, Co, S, rows,
                _DTYPE_CODE[x3.dtype], _DTYPE_CODE[w.dtype])
    return parts


def pointwise_bwd_finalize_cuda(part_dw, part_dcb, part_dg, part_db) -> Tuple[torch.Tensor, ...]:
    """``pointwise_bwd_finalize``: dW [C, Co], dcb [Co], dγ [C], dβ [C],
    float32, each the sum of its partials in a fixed order."""
    chunks, C, Co = part_dw.shape
    outs = (torch.empty_like(part_dw[0]), torch.empty_like(part_dcb[0]),
            torch.empty_like(part_dg[0, 0]), torch.empty_like(part_db[0, 0]))
    with torch.cuda.device(part_dw.device):
        _launch("pointwise_bwd_finalize", part_dw.data_ptr(), part_dcb.data_ptr(),
                part_dg.data_ptr(), part_db.data_ptr(), *(t.data_ptr() for t in outs), C, Co,
                chunks, part_dg.shape[1])
    return outs


def pointwise_bwd_reduce_cuda(x3, gamma, beta, mean, inv, w, dy) -> Tuple[torch.Tensor, ...]:
    """Pass A: ``pointwise_bwd_reduce`` then ``pointwise_bwd_finalize`` →
    dW [C, Co], dcb [Co], dγ [C], dβ [C], float32."""
    return pointwise_bwd_finalize_cuda(
        *pointwise_bwd_partials_cuda(x3, gamma, beta, mean, inv, w, dy))


def pointwise_bwd_dx_cuda(x3, gamma, beta, mean, inv, w, dy, dg, db) -> torch.Tensor:
    """``pointwise_bwd_dx``: dx [B, C, S] in x's dtype from pass A's dγ, dβ."""
    (B, C, S), Co = x3.shape, w.shape[1]
    dx = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        _launch("pointwise_bwd_dx", *_args(x3, gamma, beta, mean, inv, w), dy.data_ptr(),
                dg.data_ptr(), db.data_ptr(), dx.data_ptr(), B, C, Co, S,
                _DTYPE_CODE[x3.dtype], _DTYPE_CODE[w.dtype])
    return dx


class _CudaPointwise(torch.autograd.Function):
    """Forward ``pointwise_fwd``; backward pass A (``pointwise_bwd_reduce``,
    ``pointwise_bwd_finalize``) then pass B (``pointwise_bwd_dx``), both
    recomputing xhat and h from the saved x."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, mean, inv, w, cb):
        ctx.save_for_backward(x3, gamma, beta, mean, inv, w)
        return pointwise_fwd_cuda(x3, gamma, beta, mean, inv, w, cb)

    @staticmethod
    def backward(ctx, gy):
        x3, gamma, beta, mean, inv, w = ctx.saved_tensors
        dy = gy.to(w.dtype).contiguous()
        dw, dcb, dg, db = pointwise_bwd_reduce_cuda(x3, gamma, beta, mean, inv, w, dy)
        dx = pointwise_bwd_dx_cuda(x3, gamma, beta, mean, inv, w, dy, dg, db)
        return dx, dg, db, None, None, dw.to(w.dtype), dcb


def pointwise_cuda(x3: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   mean: torch.Tensor, inv: torch.Tensor, w: torch.Tensor,
                   cb: torch.Tensor) -> torch.Tensor:
    """K3 on x3 [B, C, S] (float32 or bfloat16), the batch statistics mean
    and inv = 1/sqrt(var + eps) [C], gamma, beta [C] and the conv bias cb
    [Co] (float32), and the 1×1 conv's matrix w [C, Co] in the compute dtype
    (float32 or bfloat16), all contiguous on one CUDA device. Returns
    y [B, Co, S] in w's dtype, differentiable in x3, gamma, beta, w and cb
    through the backward kernels."""
    _check(x3, gamma, beta, mean, inv, w, cb)
    return _CudaPointwise.apply(x3, gamma, beta, mean, inv, w, cb)
