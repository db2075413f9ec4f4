"""The train-mode BatchNorm of a bfloat16 input with float32 weight and
bias as hand-written CUDA kernels (``csrc/batchnorm.cu``), in place of
ATen's NCHW kernels, forward and backward.

``bn_fwd_cuda`` gives y, the saved mean and invstd and the running update;
``bn_bwd_cuda`` dx and the gradients of weight and bias. Both take x as
[N, C, S] (a view of the contiguous NCHW or NCL tensor), raise on a
dtype, shape, layout or device they do not take, and launch one entry
point each (``bn_fwd``, ``bn_bwd``) that runs one kernel or two, as
``bn_plan`` decides from the shape. ``bn_fwd_nhwc_cuda`` and
``bn_bwd_nhwc_cuda`` are the same for x as [R, C] with the channels
innermost (a view of a channels-last [N, C, H, W] tensor, R = N·H·W):
entry points ``bn_fwd_nhwc`` and ``bn_bwd_nhwc``, one kernel or three, as
``bn_plan_nhwc`` decides. The op over an ``nn.BatchNorm`` module, and its
plain version, is ``ops/batchnorm.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops import _build

# Launches since the last reset, each replay of a captured graph counted as
# the launches it holds (train/scan.py): one bn_fwd and one bn_bwd for each
# train-mode BatchNorm a step, of which bn_fwd_nhwc and bn_bwd_nhwc took the
# channels-innermost plan; bn_copies, the inputs ops/batchnorm.py copied
# because they were in neither layout.
LAUNCHES = _build.launch_counts("bn_fwd", "bn_bwd", "bn_fwd_nhwc", "bn_bwd_nhwc", "bn_copies")

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
HELD_ROWS = 16  # rows a lane holds in the one-pass channels-innermost kernels (csrc kHeldRows)
CLUSTER = 8  # blocks of a one-pass cluster (csrc kCluster)
# Item columns of a one-pass block: 128-byte runs of a row. Swept on an H100
# (PERF.md, Findings): 1 or 2 columns (16, 32 bytes of a row a lane) took up
# to 3 times as long at the main path's one-pass shapes, 4 and 8 the same.
CLUSTER_COLS = 8
# The two-pass channels-innermost chunks: at least this many rows, so that
# the partials (8 bytes a channel a chunk) stay within 1/32 of x's bytes
CHUNK_ROWS = 128


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


class NhwcPlan(NamedTuple):
    """How ``bn_fwd_nhwc`` and ``bn_bwd_nhwc`` cut x [R, C]: ``vec``
    channels an item (8, 16 bytes, or 1), ``cols`` item columns a block
    (``THREADS // cols`` rows a step), ``chunks`` of ``rows_per_chunk``
    rows, a block each; ``fused``: one pass each way, the CLUSTER chunks of
    a column tile held in the registers of a cluster's blocks."""

    vec: int
    cols: int
    rows_per_chunk: int
    chunks: int
    fused: bool


def bn_plan_nhwc(R: int, C: int, vec: int) -> NhwcPlan:
    """The channels-innermost plan for x [R, C] read ``vec`` channels at a
    time: a function of the shape alone, so the order of every sum is too.
    A lane keeps one column of items (the same ``vec`` channels) and walks
    rows.

    One pass where a cluster's blocks, CLUSTER_COLS columns each, hold R /
    CLUSTER rows in HELD_ROWS items a lane (R ≤ 4096 at C ≥ 64: maps of up
    to 4×4 at batch 256; one block a column tile would leave C / 64 blocks
    on the card). Else two passes: a block all columns up to THREADS (a
    warp reads one contiguous run of rows), chunks of rows for
    TARGET_BLOCKS blocks, but at least LANE_ITEMS items a lane and
    CHUNK_ROWS rows. Raises on a shape the kernels do not take."""
    if R < 1 or C < 1 or vec not in (1, 8) or C % vec:
        raise ValueError(f"bn_plan_nhwc: R {R}, C {C}, vec {vec}: R, C >= 1 and C a "
                         "multiple of vec, 1 or 8")
    V = C // vec
    per_block, cols = math.ceil(R / CLUSTER), min(V, CLUSTER_COLS)
    if per_block <= THREADS // cols * HELD_ROWS:
        return NhwcPlan(vec, cols, per_block, CLUSTER, True)
    cols = min(V, THREADS)
    rps = THREADS // cols
    tiles = math.ceil(V / cols)
    chunks = max(1, min(math.ceil(R / rps), math.ceil(TARGET_BLOCKS / tiles)))
    per = max(math.ceil(R / chunks), LANE_ITEMS * rps, CHUNK_ROWS)
    return NhwcPlan(vec, cols, per, math.ceil(R / per), False)


def _vec(row: int, *tensors: torch.Tensor) -> int:
    """8 where the innermost axis (S, or C channels-innermost) is a
    multiple of 8 and every row starts 16-byte aligned, else 1."""
    return 8 if row % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors) else 1


def _check_x(name: str, t: torch.Tensor, dims: str = "N, C, S") -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"bn_cuda: {name} is {t.dtype}; the kernels take bfloat16")
    if t.dim() != len(dims.split(", ")):
        raise ValueError(f"bn_cuda: {name} must be [{dims}], not {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"bn_cuda: {name} is not contiguous")
    if not t.is_cuda:
        raise ValueError(f"bn_cuda: {name} is on {t.device}, not a CUDA device")
    if not 1 <= t.numel() < 2**31:
        raise ValueError(f"bn_cuda: {name} has {t.numel()} elements; 1 to 2^31 - 1")


def _check_channels(x: torch.Tensor, **named: torch.Tensor) -> None:
    for name, t in named.items():
        if (t.dtype != torch.float32 or t.shape != x.shape[1:2] or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"bn_cuda: {name} must be a contiguous float32 [{x.shape[1]}] "
                             f"on {x.device}, not {t.dtype} {tuple(t.shape)} on {t.device}")


def _part(plan, C: int, device, extra: int = 0) -> Optional[torch.Tensor]:
    """The two-pass kernels' partials, [2, chunks + extra, C] float32."""
    if plan.fused:
        return None
    return torch.empty((2, plan.chunks + extra, C), dtype=torch.float32, device=device)


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


def bn_fwd_nhwc_cuda(x2: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                     running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                     momentum: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bn_fwd_cuda`` for x2 [R, C] (bfloat16, the channels innermost)
    over its R elements a channel: (y [R, C], mean [C], invstd [C])."""
    _check_x("x", x2, "R, C")
    _check_channels(x2, weight=weight, bias=bias, running_mean=running_mean,
                    running_var=running_var)
    R, C = x2.shape
    y = torch.empty_like(x2)
    stats = torch.empty((2, C), dtype=torch.float32, device=x2.device)
    plan = bn_plan_nhwc(R, C, _vec(C, x2, y))
    part = _part(plan, C, x2.device, extra=1)
    with _build.on_device(x2.device):
        _build.launch(LAUNCHES, "bn_fwd_nhwc", x2.data_ptr(), weight.data_ptr(),
                      bias.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                      y.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), _ptr(part), R, C,
                      plan.vec, plan.cols, plan.rows_per_chunk, plan.chunks, int(plan.fused),
                      eps, momentum, 1.0 - momentum, R / max(R - 1, 1))
    LAUNCHES["bn_fwd"] += 1
    return y, stats[0], stats[1]


def bn_bwd_nhwc_cuda(x2: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                     mean: torch.Tensor, invstd: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bn_bwd_cuda`` for x2 and dy [R, C] (bfloat16, the channels
    innermost): (dx [R, C], dweight [C], dbias [C])."""
    _check_x("x", x2, "R, C")
    _check_x("dy", dy, "R, C")
    if dy.shape != x2.shape or dy.device != x2.device:
        raise ValueError(f"bn_cuda: dy {tuple(dy.shape)} on {dy.device}, x {tuple(x2.shape)} "
                         f"on {x2.device}")
    _check_channels(x2, weight=weight, mean=mean, invstd=invstd)
    R, C = x2.shape
    dx = torch.empty_like(x2)
    grads = torch.empty((2, C), dtype=torch.float32, device=x2.device)
    plan = bn_plan_nhwc(R, C, _vec(C, x2, dy, dx))
    part = _part(plan, C, x2.device, extra=1)
    with _build.on_device(x2.device):
        _build.launch(LAUNCHES, "bn_bwd_nhwc", x2.data_ptr(), dy.data_ptr(), weight.data_ptr(),
                      mean.data_ptr(), invstd.data_ptr(), dx.data_ptr(), grads[0].data_ptr(),
                      grads[1].data_ptr(), _ptr(part), R, C, plan.vec, plan.cols,
                      plan.rows_per_chunk, plan.chunks, int(plan.fused))
    LAUNCHES["bn_bwd"] += 1
    return dx, grads[0], grads[1]
