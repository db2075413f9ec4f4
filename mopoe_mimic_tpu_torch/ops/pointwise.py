"""Fused train-mode BatchNorm → ReLU → 1×1 conv: the residual blocks'
opening stage (``cfg.fused_pointwise``).

Port of ``mopoe_mimic_tpu/ops/pallas_pointwise.py`` (K3). A 1×1 conv with
stride 1 is a product over the channel axis, so per element

    xhat = (x − μ)·inv,   inv = 1/sqrt(var + eps)          (float32)
    h    = relu(γ·xhat + β)                                 (float32)
    y    = Wᵀ·round(h) + cb                                 (float32 sums)

with round() to the compute dtype and y stored in it. The batch statistics
are taken outside the product (``batch_stats``: float32, the biased
variance in two passes, as the port's ``nn.BatchNorm``; the JAX op's fast
form E[x²] − μ² loses up to 4e-2 of a gradient's max, ROADMAP queue 3).
The backward is the full train-mode BatchNorm backward in two passes that
recompute xhat and h from x:

  pass A:  dĥ = (W·dy)·1[h > 0];  dW = Σ round(h)·dyᵀ, dcb = Σ dy,
           dγ = Σ dĥ·xhat, dβ = Σ dĥ            (sums over batch × spatial)
  pass B:  dx = γ·inv·(dĥ − dβ/R − xhat·dγ/R)

with dy cast to the compute dtype first (pallas_pointwise.py:188), dW
returned in the compute dtype (:241), dγ, dβ and dcb in float32 and dx in
x's dtype.

Layouts are the port's: x [B, C, *spatial] (NCHW or NCL), taken as
[B, C, S] with S the flattened spatial size; W [C, Co]; y [B, Co, *spatial].

``fused_bn_relu_pointwise`` dispatches on the device of its tensors: on CUDA
to the hand-written kernels (``ops/cuda_pointwise.py``, ``csrc/pointwise.cu``),
which launch or raise, the batch statistics and the running-statistics
update included (``pointwise_stats``); on the CPU to the plain versions
here (``batch_stats``, ``inv_std``, ``update_running_stats``, and the
passes, which mirror the Pallas kernels ``_fwd_kernel`` (:81),
``_bwd_reduce_kernel`` (:88) and ``_bwd_dx_kernel`` (:119)): the kernels'
oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops import cuda_pointwise


def batch_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance E[(x − μ)²] of x [B, C, ...] over
    every axis but 1, in float32 (float64 for float64 x)."""
    xf = x if x.dtype == torch.float64 else x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    mean = xf.mean(dims)
    centred = xf - mean.reshape((1, -1) + (1,) * (x.dim() - 2))
    return mean, centred.square().mean(dims)


def inv_std(var: torch.Tensor, eps: float) -> torch.Tensor:
    """1 / sqrt(var + eps), each operation correctly rounded. Not
    ``torch.rsqrt``: on CUDA it is an approximation (up to 2 ulp), and the
    flagship's BatchNorms at 1×1 spatial amplify that tenfold in a float32
    step's gradients (PERF.md, section 6)."""
    return 1.0 / torch.sqrt(var + eps)


@torch.no_grad()
def update_running_stats(running_mean: torch.Tensor, running_var: torch.Tensor,
                         momentum: float, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
    """``nn.BatchNorm``'s train-mode update of its running buffers, in place,
    from the batch statistics over n elements: momentum, the running
    variance unbiased by n/(n − 1)."""
    m = momentum
    running_mean.mul_(1.0 - m).add_(mean.to(running_mean.dtype), alpha=m)
    running_var.mul_(1.0 - m).add_((var * (n / max(n - 1, 1))).to(running_var.dtype), alpha=m)


def conv1x1_matrix(weight: torch.Tensor, transpose: bool) -> torch.Tensor:
    """The [C, Co] matrix of a 1×1 conv's weight: a Conv{1,2}d holds
    [Co, C, 1…] (W is its transpose), a ConvTranspose{1,2}d [C, Co, 1…]
    (models/jax_import.py:48-57). C = Co in every block, so only
    non-symmetric weights tell the two apart."""
    w = weight.reshape(weight.shape[:2])
    return w if transpose else w.t()


def _col(v: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return v.to(dtype).reshape(1, -1, 1)


def _norm(x3, gamma, beta, mean, inv) -> Tuple[torch.Tensor, torch.Tensor]:
    """xhat and h = relu(γ·xhat + β) of x3 [B, C, S] in float32 (float64
    for float64 x), each operation rounded on its own, as the kernels do."""
    nd = torch.promote_types(x3.dtype, torch.float32)
    xhat = (x3.to(nd) - _col(mean, nd)) * _col(inv, nd)
    return xhat, torch.relu(_col(gamma, nd) * xhat + _col(beta, nd))


def _acc(w: torch.Tensor, acc_dtype: Optional[torch.dtype]) -> torch.dtype:
    """float32 sums as the kernels, or float64 for a float64 model or when
    asked (an oracle for long sums)."""
    return acc_dtype or torch.promote_types(w.dtype, torch.float32)


def pointwise_fwd_plain(x3, gamma, beta, mean, inv, w, cb,
                        acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y [B, Co, S] = Wᵀ·round(h) + cb in ``acc_dtype`` (default ``_acc``),
    h rounded to w's dtype, the compute dtype; the caller rounds y to it."""
    acc = _acc(w, acc_dtype)
    _, h = _norm(x3, gamma, beta, mean, inv)
    return torch.matmul(w.to(acc).t(), h.to(w.dtype).to(acc)) + _col(cb, acc)


def _dh_relu(x3, gamma, beta, mean, inv, w, dy, acc):
    """xhat, round(h) and dĥ = (W·dy)·1[h > 0] [B, C, S]."""
    xhat, h = _norm(x3, gamma, beta, mean, inv)
    dh = torch.matmul(w.to(acc), dy.to(acc))
    return xhat, h.to(w.dtype).to(acc), torch.where(h > 0, dh, torch.zeros_like(dh))


def pointwise_bwd_reduce_plain(x3, gamma, beta, mean, inv, w, dy,
                               acc_dtype: Optional[torch.dtype] = None
                               ) -> Tuple[torch.Tensor, ...]:
    """Pass A from dy [B, Co, S] in the compute dtype: dW [C, Co], dcb [Co],
    dγ [C], dβ [C], summed in ``acc_dtype``."""
    acc = _acc(w, acc_dtype)
    xhat, hr, dhr = _dh_relu(x3, gamma, beta, mean, inv, w, dy, acc)
    dya = dy.to(acc)
    dw = torch.einsum("bcs,bos->co", hr, dya)
    return dw, dya.sum((0, 2)), (dhr * xhat).sum((0, 2)), dhr.sum((0, 2))


def pointwise_bwd_dx_plain(x3, gamma, beta, mean, inv, w, dy, dgamma, dbeta,
                           acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Pass B: dx [B, C, S] = γ·inv·(dĥ − dβ/R − xhat·dγ/R) in ``acc_dtype``,
    from pass A's dγ and dβ; R = B·S."""
    acc = _acc(w, acc_dtype)
    xhat, _, dhr = _dh_relu(x3, gamma, beta, mean, inv, w, dy, acc)
    n = x3.shape[0] * x3.shape[2]
    nd = xhat.dtype
    return (_col(gamma, nd) * _col(inv, nd)
            * (dhr - _col(dbeta, acc) / n - xhat * _col(dgamma, acc) / n))


class _PlainPointwise(torch.autograd.Function):
    """The plain forward and its two-pass backward; saves x, not h."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, mean, inv, w, cb):
        with torch.autocast(x3.device.type, enabled=False):
            y = pointwise_fwd_plain(x3, gamma, beta, mean, inv, w, cb)
        ctx.save_for_backward(x3, gamma, beta, mean, inv, w)
        return y.to(w.dtype)

    @staticmethod
    def backward(ctx, gy):
        x3, gamma, beta, mean, inv, w = ctx.saved_tensors
        dy = gy.to(w.dtype)
        with torch.autocast(x3.device.type, enabled=False):
            dw, dcb, dg, db = pointwise_bwd_reduce_plain(x3, gamma, beta, mean, inv, w, dy)
            dx = pointwise_bwd_dx_plain(x3, gamma, beta, mean, inv, w, dy, dg, db)
        return (dx.to(x3.dtype), dg.to(gamma.dtype), db.to(beta.dtype), None, None,
                dw.to(w.dtype), dcb)


def fused_bn_relu_pointwise(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                            weight_ck: torch.Tensor, bias: Optional[torch.Tensor], eps: float,
                            compute_dtype: torch.dtype,
                            running: Optional[Tuple[torch.Tensor, torch.Tensor, float]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode ``conv1x1(relu(batchnorm(x)))`` over channel axis 1.

    x [B, C, *spatial] (float32 or bfloat16; float64 on the CPU); gamma,
    beta [C]; weight_ck [C, Co] (cast to ``compute_dtype`` here, as the
    conv's autocast would); bias [Co] or None; eps the BatchNorm epsilon;
    ``running`` None or (running_mean, running_var, momentum): the
    BatchNorm's buffers, updated in place as ``nn.BatchNorm`` does in train
    mode (``update_running_stats``; its ``num_batches_tracked`` is the
    caller's). Returns ``(y, mean, var)``: y [B, Co, *spatial] in
    ``compute_dtype``, differentiable in x, gamma, beta, weight_ck and bias
    with the full train-mode BatchNorm backward; mean and var [C] the batch
    statistics, detached.
    """
    B, C = x.shape[:2]
    x3 = x.reshape(B, C, -1).contiguous()
    w = weight_ck.to(compute_dtype).contiguous()
    Co = w.shape[1]
    cb = torch.zeros(Co, dtype=gamma.dtype, device=x.device) if bias is None else bias
    tensors = (x, gamma, beta, w, cb)
    if all(t.is_cuda for t in tensors):
        mean, var, inv = cuda_pointwise.pointwise_stats_cuda(x3, eps, running)
        y = cuda_pointwise.pointwise_cuda(x3, gamma, beta, mean, inv, w, cb)
    elif not any(t.is_cuda for t in tensors):
        with torch.no_grad():
            mean, var = batch_stats(x3)
            inv = inv_std(var, eps)
            if running is not None:
                update_running_stats(*running, mean, var, x3.shape[0] * x3.shape[2])
        y = _PlainPointwise.apply(x3, gamma, beta, mean, inv, w, cb)
    else:
        raise ValueError("fused_bn_relu_pointwise: inputs lie on different devices")
    return y.reshape(B, Co, *x.shape[2:]), mean, var
