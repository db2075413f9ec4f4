"""The train-mode BatchNorm of a bfloat16 input with float32 weight and
bias as hand-written CUDA kernels (``csrc/batchnorm.cu``), in place of
ATen's NCHW kernels, forward and backward.

``bn_fwd_cuda`` gives y, the saved mean and invstd and the running update;
``bn_bwd_cuda`` dx and the gradients of weight and bias. Both take x as
[N, C, S] (a view of the contiguous NCHW or NCL tensor), raise on a
dtype, shape, layout or device they do not take, and launch one entry
point each (``bn_fwd``, ``bn_bwd``) that runs one kernel or two, as
``bn_plan`` decides from the shape. The op over an ``nn.BatchNorm``
module, and its plain version, is ``ops/batchnorm.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops import _build

# Launches of each entry point since the last reset, each replay of a
# captured graph counted as the launches it holds (train/scan.py): one
# bn_fwd and one bn_bwd for each train-mode BatchNorm a step.
LAUNCHES = _build.launch_counts("bn_fwd", "bn_bwd")

THREADS = 256  # csrc/batchnorm.cu kThreads
HELD = 8  # items a lane holds in the one-pass kernels (csrc kHeld)
UNROLL = 4  # items a lane loads at once in the two-pass kernels (csrc kUnroll)
# The two-pass grid: eight 256-thread blocks for each of an H100's 132 SMs,
# 1.6-2.7 waves at the kernels' 50-76 registers a thread, and at least two
# loads of UNROLL items a lane. Swept on an H100 at the main path's
# two-pass shapes (PERF.md, Findings): twice the blocks, or half the items a
# lane, took up to 1.4 times as long.
TARGET_BLOCKS = 8 * 132
LANE_ITEMS = 2 * UNROLL


class Plan(NamedTuple):
    """How ``bn_fwd`` and ``bn_bwd`` cut x [N, C, S]: ``vec`` elements an
    item (8, 16 bytes, or 1), ``tpc`` lanes a channel, ``b_per_chunk``
    whole b a chunk and ``chunks`` of them; ``fused``: one pass each way,
    a block holding its channels' whole slices."""

    vec: int
    tpc: int
    b_per_chunk: int
    chunks: int
    fused: bool


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def bn_plan(N: int, C: int, S: int, vec: int) -> Plan:
    """The plan for x [N, C, S] read ``vec`` elements at a time: a function
    of the shape alone, so the order of every sum is too.

    One pass wherever a channel's N·S/vec items fit in THREADS lanes of
    HELD items (at every main-path shape where both fit, one pass took
    0.35-0.75 of two passes' time on an H100: PERF.md, Findings): a lane an
    item up to THREADS lanes (a power of two), a block a channel beyond.
    Else two passes: tpc a power of two up to 32, no more than the items
    of one (b, c) run, so that a warp reads whole runs; chunks of whole b,
    enough (channel group, chunk) blocks for TARGET_BLOCKS, but at least
    LANE_ITEMS items a lane."""
    items = N * (S // vec)
    if items <= THREADS * HELD:
        return Plan(vec, min(THREADS, _pow2_at_least(items)), N, 1, True)
    tpc = 1
    while tpc < 32 and 2 * tpc <= S // vec:
        tpc *= 2
    groups = math.ceil(C / (THREADS // tpc))
    chunks = max(1, min(N, math.ceil(TARGET_BLOCKS / groups)))
    per = max(math.ceil(N / chunks), math.ceil(LANE_ITEMS * tpc / (S // vec)))
    return Plan(vec, tpc, per, math.ceil(N / per), False)


def _vec(S: int, *tensors: torch.Tensor) -> int:
    """8 where S is a multiple of 8 and every row starts 16-byte aligned,
    else 1."""
    return 8 if S % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check_x(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"bn_cuda: {name} is {t.dtype}; the kernels take bfloat16")
    if t.dim() != 3:
        raise ValueError(f"bn_cuda: {name} must be [N, C, S], not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bn_cuda: {name} is not contiguous")
    if not t.is_cuda:
        raise ValueError(f"bn_cuda: {name} is on {t.device}, not a CUDA device")
    if not 1 <= t.numel() < 2**31:
        raise ValueError(f"bn_cuda: {name} has {t.numel()} elements; 1 to 2^31 - 1")


def _check_channels(x3: torch.Tensor, **named: torch.Tensor) -> None:
    for name, t in named.items():
        if (t.dtype != torch.float32 or t.shape != x3.shape[1:2] or not t.is_contiguous()
                or t.device != x3.device):
            raise ValueError(f"bn_cuda: {name} must be a contiguous float32 [{x3.shape[1]}] "
                             f"on {x3.device}, not {t.dtype} {tuple(t.shape)} on {t.device}")


def _part(plan: Plan, C: int, device) -> Optional[torch.Tensor]:
    """The two-pass kernels' partials, [2, chunks, C] float32."""
    if plan.fused:
        return None
    return torch.empty((2, plan.chunks, C), dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def bn_fwd_cuda(x3: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                momentum: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode BatchNorm of x3 [N, C, S] (bfloat16) over its n = N·S
    elements a channel: (y [N, C, S] bfloat16, mean [C], invstd [C]),
    invstd = 1/sqrt(var + eps) of the biased variance; the running buffers
    updated in place with ``momentum``, the variance unbiased by
    n/(n − 1)."""
    _check_x("x", x3)
    _check_channels(x3, weight=weight, bias=bias, running_mean=running_mean,
                    running_var=running_var)
    N, C, S = x3.shape
    y = torch.empty_like(x3)
    stats = torch.empty((2, C), dtype=torch.float32, device=x3.device)
    plan = bn_plan(N, C, S, _vec(S, x3, y))
    part = _part(plan, C, x3.device)
    n = N * S
    with _build.on_device(x3.device):
        _build.launch(LAUNCHES, "bn_fwd", x3.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                      running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
                      stats[0].data_ptr(), stats[1].data_ptr(), _ptr(part), N, C, S, plan.vec,
                      plan.tpc, plan.b_per_chunk, int(plan.fused), eps, momentum,
                      1.0 - momentum, n / max(n - 1, 1))
    return y, stats[0], stats[1]


def bn_bwd_cuda(x3: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                invstd: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``bn_fwd_cuda`` from its saved x3, mean and invstd:
    (dx [N, C, S] bfloat16, dweight [C], dbias [C] float32) from dy
    [N, C, S] bfloat16."""
    _check_x("x", x3)
    _check_x("dy", dy)
    if dy.shape != x3.shape or dy.device != x3.device:
        raise ValueError(f"bn_cuda: dy {tuple(dy.shape)} on {dy.device}, x {tuple(x3.shape)} "
                         f"on {x3.device}")
    _check_channels(x3, weight=weight, mean=mean, invstd=invstd)
    N, C, S = x3.shape
    dx = torch.empty_like(x3)
    grads = torch.empty((2, C), dtype=torch.float32, device=x3.device)
    plan = bn_plan(N, C, S, _vec(S, x3, dy, dx))
    part = _part(plan, C, x3.device)
    with _build.on_device(x3.device):
        _build.launch(LAUNCHES, "bn_bwd", x3.data_ptr(), dy.data_ptr(), weight.data_ptr(),
                      mean.data_ptr(), invstd.data_ptr(), dx.data_ptr(), grads[0].data_ptr(),
                      grads[1].data_ptr(), _ptr(part), N, C, S, plan.vec, plan.tpc,
                      plan.b_per_chunk, int(plan.fused))
    return dx, grads[0], grads[1]
