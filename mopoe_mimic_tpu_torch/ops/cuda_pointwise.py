"""K3: the fused train-mode BN → ReLU → 1×1 conv as hand-written CUDA kernels.

Replaces the Pallas TPU kernels ``_fwd_kernel``, ``_bwd_reduce_kernel`` and
``_bwd_dx_kernel`` of ``mopoe_mimic_tpu/ops/pallas_pointwise.py`` (:81, :88,
:119). The kernels are ``csrc/pointwise.cu``, joined by a
``torch.autograd.Function`` that saves x, not the normalised activations:
the forward (y), pass A (dW, dcb, dγ, dβ: per-chunk partial sums, then
``pointwise_bwd_finalize``, which sums them in a fixed order: no atomics,
so two equal steps give equal gradients) and pass B (dx). They index the
port's [B, C, S] layout directly. Their plain PyTorch versions are
``ops/pointwise.pointwise_{fwd,bwd_reduce,bwd_dx}_plain``.

The wrappers dispatch on W's dtype, as ``ops/cuda_texthead.py`` does for
K2: a bfloat16 W (bf16 autocast) runs the forward and both passes on
tensor cores (``pointwise_fwd_tc``, ``pointwise_bwd_reduce_tc``,
``pointwise_bwd_dx_tc``), a float32 W on the CUDA cores (``pointwise_fwd``,
``pointwise_bwd_reduce``, ``pointwise_bwd_dx``). A bfloat16 call never
reaches the float32 kernels, and a kernel that fails to launch raises.

``pointwise_stats_cuda`` takes the op's batch statistics (mean, the biased
variance and inv = 1/sqrt(var + eps)) and bn1's running update in one
function, ``pointwise_stats`` (per-chunk partials) and
``pointwise_stats_finalize`` (merged in a fixed order); its plain version
is ``ops/pointwise.batch_stats``, ``inv_std`` and ``update_running_stats``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops import _build

# Launches of each kernel since the last reset, each replay of a captured
# graph counted as the launches it holds (train/scan.py); read by
# chip_smoke.py to show that the main path went through the kernels.
LAUNCHES = _build.launch_counts(
    "pointwise_fwd", "pointwise_fwd_tc", "pointwise_bwd_reduce", "pointwise_bwd_reduce_tc",
    "pointwise_bwd_finalize", "pointwise_bwd_dx", "pointwise_bwd_dx_tc", "pointwise_stats",
    "pointwise_stats_finalize")

MAX_CHANNELS = 2048
# pointwise_fwd_tc keeps all C rows of W's 64-output slice in shared memory,
# pointwise_bwd_dx_tc all Co columns of its 64-channel slice
MAX_TC_CHANNELS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # channels, outputs and rows of pass A's tiles (csrc/pointwise.cu AT, TC_T)
TARGET_BLOCKS = 4 * 132  # float32 pass A: about four blocks per SM of an H100
WAVE_BLOCKS = 2 * 132  # bfloat16 passes A and B: the two blocks each SM of an H100 holds
STATS_THREADS = 256  # csrc/pointwise.cu ST_THREADS
STATS_BLOCKS = 8 * 132  # pointwise_stats: eight blocks of 256 threads fill an SM of an H100


def reduce_chunks(R: int, C: int, Co: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of float32 pass A: enough (chunk, channel
    tile, output tile) blocks to fill the card, each chunk a multiple of
    TILE rows. A function of the shape alone, so the order of the sums is
    too."""
    tiles = math.ceil(C / TILE) * math.ceil(Co / TILE)
    n = max(1, min(math.ceil(R / TILE), math.ceil(TARGET_BLOCKS / tiles)))
    rows = math.ceil(math.ceil(R / n) / TILE) * TILE
    return rows, math.ceil(R / rows)


def pass_a_input_bytes(R: int, C: int, Co: int, x_bytes: int) -> int:
    """What bfloat16 pass A must read: x, dy (bf16) and W (bf16)."""
    return R * (C * x_bytes + 2 * Co) + 2 * C * Co


def pass_a_scratch_bytes(R: int, C: int, Co: int, chunks: int) -> int:
    """Pass A's partials, written once and read once by the finalize: dW and
    dcb per chunk where there are several (one chunk writes them as they
    are), dγ and dβ per chunk and output tile."""
    per_chunk = (C * Co + Co) * 4 if chunks > 1 else 0
    return 2 * chunks * (per_chunk + 2 * math.ceil(Co / TILE) * C * 4)


def reduce_tc_chunks(R: int, C: int, Co: int, x_bytes: int) -> Tuple[int, int]:
    """(rows per chunk, chunks) of bfloat16 pass A: one wave of (chunk,
    channel tile, output tile) blocks, WAVE_BLOCKS, but no more chunks than
    keep the partials' traffic (``pass_a_scratch_bytes``) below the bytes
    of the inputs; one chunk where even two would not. Chunks are a multiple
    of TILE rows; a function of the shape alone, so the order of the sums
    is too."""
    tiles = math.ceil(C / TILE) * math.ceil(Co / TILE)
    row_tiles = math.ceil(R / TILE)
    n = max(1, min(row_tiles, WAVE_BLOCKS // tiles))
    inputs = pass_a_input_bytes(R, C, Co, x_bytes)
    while n > 1 and pass_a_scratch_bytes(R, C, Co, n) >= inputs:
        n -= 1
    rows = math.ceil(row_tiles / n) * TILE
    return rows, math.ceil(R / rows)


def dx_tc_rows(R: int, C: int) -> int:
    """The row tile of bfloat16 pass B (``pointwise_bwd_dx_tc``): 64 rows,
    or 32 or 16 where 64-row tiles would give fewer (row tile, channel
    tile) blocks than one wave (WAVE_BLOCKS): the largest that fills it,
    else 16. Each row tile is one block's, whole, so every row's dx is
    computed once; a function of the shape alone."""
    c_tiles = math.ceil(C / TILE)
    for rows in (64, 32):
        if math.ceil(R / rows) * c_tiles >= WAVE_BLOCKS:
            return rows
    return 16


def stats_lanes(S: int, x_bytes: int) -> int:
    """The lanes that share a channel in ``pointwise_stats`` (csrc
    ``stats_lanes``): a power of two up to 32, no more than the channel's
    groups of 16 bytes (or of single elements where S is not a multiple of
    a group) in one b."""
    group = 16 // x_bytes if S % (16 // x_bytes) == 0 else 1
    lanes = 1
    while lanes < 32 and 2 * lanes <= S // group:
        lanes *= 2
    return lanes


def stats_chunks(B: int, C: int, S: int, x_bytes: int) -> Tuple[int, int]:
    """(b per chunk, chunks) of ``pointwise_stats``: chunks of whole b, enough
    (chunk, channel group) blocks to fill the card (STATS_BLOCKS), but no
    more chunks than keep the partials' traffic (a mean and an M2 a chunk
    and channel, written and read: 16 bytes) below the bytes of x. A
    function of the shape alone, so the order of the merges is too."""
    groups = math.ceil(C / (STATS_THREADS // stats_lanes(S, x_bytes)))
    n = max(1, min(B, math.ceil(STATS_BLOCKS / groups)))
    while n > 1 and 16 * n >= B * S * x_bytes:
        n -= 1
    per = math.ceil(B / n)
    return per, math.ceil(B / per)


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
    most = MAX_TC_CHANNELS if w.dtype == torch.bfloat16 else MAX_CHANNELS
    if not (1 <= C <= most and 1 <= Co <= most):
        raise ValueError(f"pointwise_cuda: {C} → {Co} channels; the kernels take 1..{most} → "
                         f"1..{most} with a {w.dtype} weight")
    if not 1 <= B * S < 2**31:
        raise ValueError(f"pointwise_cuda: {B}·{S} rows; the kernels take 1 to 2^31 - 1")


def _args(x3, gamma, beta, mean, inv, w):
    return (x3.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            w.data_ptr())


def pointwise_fwd_cuda(x3, gamma, beta, mean, inv, w, cb) -> torch.Tensor:
    """y [B, Co, S] in w's dtype: ``pointwise_fwd_tc`` for a bfloat16 w,
    ``pointwise_fwd`` for a float32 one."""
    (B, C, S), Co = x3.shape, w.shape[1]
    y = torch.empty((B, Co, S), dtype=w.dtype, device=x3.device)
    args = (*_args(x3, gamma, beta, mean, inv, w), cb.data_ptr(), y.data_ptr(), B, C, Co, S,
            _DTYPE_CODE[x3.dtype])
    with _build.on_device(x3.device):
        if w.dtype == torch.bfloat16:
            _build.launch(LAUNCHES, "pointwise_fwd_tc", *args)
        else:
            _build.launch(LAUNCHES, "pointwise_fwd", *args, _DTYPE_CODE[w.dtype])
    return y


def pointwise_bwd_partials_cuda(x3, gamma, beta, mean, inv, w, dy) -> Tuple[torch.Tensor, ...]:
    """Pass A's partial sums per row chunk (and, for dγ and dβ, per output
    tile): part_dw [chunks, C, Co], part_dcb [chunks, Co], part_dg and
    part_db [chunks, Co tiles, C], float32; dy [B, Co, S] in w's dtype.
    ``pointwise_bwd_reduce_tc`` (chunks from ``reduce_tc_chunks``) for a
    bfloat16 w, ``pointwise_bwd_reduce`` (``reduce_chunks``) for a float32
    one. With one chunk, part_dw[0] and part_dcb[0] are dW and dcb."""
    (B, C, S), Co = x3.shape, w.shape[1]
    tc = w.dtype == torch.bfloat16
    rows, chunks = (reduce_tc_chunks(B * S, C, Co, x3.element_size()) if tc
                    else reduce_chunks(B * S, C, Co))
    o_tiles = math.ceil(Co / TILE)
    f32 = dict(dtype=torch.float32, device=x3.device)
    parts = (torch.empty((chunks, C, Co), **f32), torch.empty((chunks, Co), **f32),
             torch.empty((chunks, o_tiles, C), **f32), torch.empty((chunks, o_tiles, C), **f32))
    args = (*_args(x3, gamma, beta, mean, inv, w), dy.data_ptr(), *(t.data_ptr() for t in parts),
            B, C, Co, S, rows, _DTYPE_CODE[x3.dtype])
    with _build.on_device(x3.device):
        if tc:
            _build.launch(LAUNCHES, "pointwise_bwd_reduce_tc", *args)
        else:
            _build.launch(LAUNCHES, "pointwise_bwd_reduce", *args, _DTYPE_CODE[w.dtype])
    return parts


def pointwise_bwd_finalize_cuda(part_dw, part_dcb, part_dg, part_db) -> Tuple[torch.Tensor, ...]:
    """``pointwise_bwd_finalize``: dW [C, Co], dcb [Co], dγ [C], dβ [C],
    float32, each the sum of its partials in a fixed order. With one chunk,
    dW and dcb are the partials themselves and only dγ and dβ are summed
    (over the output tiles)."""
    chunks, C, Co = part_dw.shape
    if chunks == 1:
        dw, dcb = part_dw[0], part_dcb[0]
    else:
        dw, dcb = torch.empty_like(part_dw[0]), torch.empty_like(part_dcb[0])
    dg, db = torch.empty_like(part_dg[0, 0]), torch.empty_like(part_db[0, 0])
    with _build.on_device(part_dw.device):
        _build.launch(LAUNCHES, "pointwise_bwd_finalize", part_dw.data_ptr(), part_dcb.data_ptr(),
                      part_dg.data_ptr(), part_db.data_ptr(),
                      *(t.data_ptr() for t in (dw, dcb, dg, db)), C, Co, chunks,
                      part_dg.shape[1])
    return dw, dcb, dg, db


def pointwise_bwd_reduce_cuda(x3, gamma, beta, mean, inv, w, dy) -> Tuple[torch.Tensor, ...]:
    """Pass A: the partials, then ``pointwise_bwd_finalize`` → dW [C, Co],
    dcb [Co], dγ [C], dβ [C], float32."""
    return pointwise_bwd_finalize_cuda(
        *pointwise_bwd_partials_cuda(x3, gamma, beta, mean, inv, w, dy))


def pointwise_bwd_dx_cuda(x3, gamma, beta, mean, inv, w, dy, dg, db) -> torch.Tensor:
    """Pass B: dx [B, C, S] in x's dtype from pass A's dγ, dβ;
    ``pointwise_bwd_dx_tc`` (row tiles of ``dx_tc_rows``) for a bfloat16 w,
    ``pointwise_bwd_dx`` for a float32 one."""
    (B, C, S), Co = x3.shape, w.shape[1]
    dx = torch.empty_like(x3)
    args = (*_args(x3, gamma, beta, mean, inv, w), dy.data_ptr(), dg.data_ptr(), db.data_ptr(),
            dx.data_ptr(), B, C, Co, S)
    with _build.on_device(x3.device):
        if w.dtype == torch.bfloat16:
            _build.launch(LAUNCHES, "pointwise_bwd_dx_tc", *args, dx_tc_rows(B * S, C),
                          _DTYPE_CODE[x3.dtype])
        else:
            _build.launch(LAUNCHES, "pointwise_bwd_dx", *args, _DTYPE_CODE[x3.dtype],
                          _DTYPE_CODE[w.dtype])
    return dx


def pointwise_stats_cuda(x3: torch.Tensor, eps: float,
                         running: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batch statistics of x3 [B, C, S] (float32 or bfloat16, contiguous,
    on a CUDA device) over its n = B·S rows: (mean, var, inv) [C] float32,
    var biased, inv = 1/sqrt(var + eps). With ``running`` = (running_mean,
    running_var, momentum), float32 [C] buffers on x3's device, also
    ``nn.BatchNorm``'s running update of both in place (the variance
    unbiased by n/(n − 1)). ``pointwise_stats`` (per-chunk partials, chunks
    from ``stats_chunks``), then ``pointwise_stats_finalize``."""
    _check_stats(x3, running)
    B, C, S = x3.shape
    per = stats_chunks(B, C, S, x3.element_size())[0]
    return pointwise_stats_finalize_cuda(pointwise_stats_partials_cuda(x3), B, S, per, eps,
                                         running)


def pointwise_stats_partials_cuda(x3: torch.Tensor) -> torch.Tensor:
    """``pointwise_stats``: per chunk of ``stats_chunks`` and channel, the
    chunk's mean and M2 (Σ of squared deviations), [2, chunks, C] float32."""
    B, C, S = x3.shape
    per, chunks = stats_chunks(B, C, S, x3.element_size())
    part = torch.empty((2, chunks, C), dtype=torch.float32, device=x3.device)
    with _build.on_device(x3.device):
        _build.launch(LAUNCHES, "pointwise_stats", x3.data_ptr(), part[0].data_ptr(),
                      part[1].data_ptr(), B, C, S, per, _DTYPE_CODE[x3.dtype])
    return part


def pointwise_stats_finalize_cuda(part: torch.Tensor, B: int, S: int, per: int, eps: float,
                                  running=None) -> Tuple[torch.Tensor, ...]:
    """``pointwise_stats_finalize``: the chunks' partials (chunks of ``per``
    whole b of x [B, C, S]) merged in a fixed order → (mean, var, inv) [C],
    and the running update where ``running`` is given."""
    C = part.shape[2]
    out = torch.empty((3, C), dtype=torch.float32, device=part.device)
    rm, rv, m = running if running is not None else (None, None, 0.0)
    n = B * S
    with _build.on_device(part.device):
        _build.launch(LAUNCHES, "pointwise_stats_finalize", part[0].data_ptr(),
                      part[1].data_ptr(), *(t.data_ptr() for t in out),
                      None if rm is None else rm.data_ptr(), None if rv is None else rv.data_ptr(),
                      B, C, S, per, eps, m, 1.0 - m, n / max(n - 1, 1))
    mean, var, inv = out.unbind(0)
    return mean, var, inv


def _check_stats(x3, running) -> None:
    if not x3.is_cuda:
        raise ValueError(f"pointwise_stats_cuda: x is on {x3.device}, not a CUDA device")
    if x3.dtype not in _DTYPE_CODE or x3.dim() != 3 or not x3.is_contiguous():
        raise ValueError(f"pointwise_stats_cuda: x must be a contiguous [B, C, S] float32 or "
                         f"bfloat16 tensor, not {x3.dtype} {tuple(x3.shape)}")
    if not 1 <= x3.numel() < 2**31:
        raise ValueError(f"pointwise_stats_cuda: {x3.numel()} elements; 1 to 2^31 - 1")
    if running is not None:
        for t in running[:2]:
            if (t.device != x3.device or t.dtype != torch.float32 or t.shape != x3.shape[1:2]
                    or not t.is_contiguous()):
                raise ValueError("pointwise_stats_cuda: the running buffers must be contiguous "
                                 f"float32 [{x3.shape[1]}] on {x3.device}")


class _CudaPointwise(torch.autograd.Function):
    """Forward; backward pass A (partials and their finalize) then pass B,
    both recomputing xhat and h from the saved x."""

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
