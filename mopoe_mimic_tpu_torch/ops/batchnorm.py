"""Train-mode BatchNorm over an ``nn.BatchNorm{1,2}d`` module's own
parameters and buffers, on the port's kernels for a CUDA input.

``batch_norm_train(x, bn)`` is ``bn(x)`` in train mode: the batch mean
and biased variance in float32, invstd = 1/sqrt(var + eps), the normalize
and affine in float32 with the output in x's dtype, the running
statistics advanced with ``bn.momentum`` (the variance unbiased by
n/(n − 1)) and ``bn.num_batches_tracked`` by one; weight and bias get
float32 gradients, x one in its dtype. The state-dict keys are the
module's.

For a CUDA tensor it runs ``ops/cuda_batchnorm.py``'s kernels (bfloat16
x, float32 parameters; ``csrc/batchnorm.cu``), which launch or raise: a
``torch.autograd.Function`` that saves x, the mean and invstd, as ATen's
BatchNorm does. A channels-last x takes the channels-innermost plan and
gives a channels-last y and dx; a contiguous one the [N, C, S] plan. Its
plain version, taken for a CPU tensor only, is
``torch.nn.functional.batch_norm`` on the same parameters and buffers.
``models/resblocks.py`` routes the residual blocks' train-mode bfloat16
BatchNorms on the card here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn
from torch import nn

from mopoe_mimic_tpu_torch.ops import cuda_batchnorm


class _CudaBatchNorm(torch.autograd.Function):
    """``bn_fwd_nhwc_cuda`` on a channels-last x [N, C, H, W] read in place
    as [N·H·W, C], or ``bn_fwd_cuda`` on a contiguous x [N, C, *spatial]
    viewed as [N, C, S]; the backward from the saved x, mean and invstd on
    the same plan, gy read in x's layout: one autograd node a BatchNorm, as
    ATen's."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum):
        ctx.nhwc = nhwc = channels_last(x)
        if nhwc:
            y, mean, invstd = cuda_batchnorm.bn_fwd_nhwc_cuda(_as_rows(x), weight, bias,
                                                              running_mean, running_var, eps,
                                                              momentum)
        else:
            y, mean, invstd = cuda_batchnorm.bn_fwd_cuda(_as_3d(x), weight, bias,
                                                         running_mean, running_var, eps,
                                                         momentum)
        ctx.save_for_backward(x, weight, mean, invstd)
        return _like(y, x, nhwc)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd = ctx.saved_tensors
        gy = readable(gy, ctx.nhwc)
        if ctx.nhwc:
            dx, dweight, dbias = cuda_batchnorm.bn_bwd_nhwc_cuda(_as_rows(x), _as_rows(gy),
                                                                 weight, mean, invstd)
        else:
            dx, dweight, dbias = cuda_batchnorm.bn_bwd_cuda(_as_3d(x), _as_3d(gy), weight,
                                                            mean, invstd)
        return _like(dx, x, ctx.nhwc), dweight, dbias, None, None, None, None


def channels_last(t: torch.Tensor) -> bool:
    """Whether t is a 4-D tensor whose channels are innermost in memory
    (also a contiguous [N, C, 1, 1], whose memory is the same)."""
    return t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)


def readable(t: torch.Tensor, nhwc: bool) -> torch.Tensor:
    """t in the layout a plan reads, channels-last or contiguous: itself
    where it is, else one copy, counted in ``LAUNCHES["bn_copies"]``."""
    if channels_last(t) if nhwc else t.is_contiguous():
        return t
    cuda_batchnorm.LAUNCHES["bn_copies"] += 1
    return t.contiguous(memory_format=torch.channels_last if nhwc else torch.contiguous_format)


def _as_3d(t: torch.Tensor) -> torch.Tensor:
    return t.view(t.shape[0], t.shape[1], -1)


def _as_rows(t: torch.Tensor) -> torch.Tensor:
    """A channels-last [N, C, H, W] as the [N·H·W, C] matrix it is in memory."""
    return t.permute(0, 2, 3, 1).view(-1, t.shape[1])


def _like(out: torch.Tensor, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
    """A kernel's output ([R, C] or [N, C, S]) as x's shape in x's layout."""
    if nhwc:
        N, C, H, W = x.shape
        return out.view(N, H, W, C).permute(0, 3, 1, 2)
    return out.view(x.shape)


def batch_norm_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """``bn(x)`` in train mode for x [N, C, *spatial]: on the kernels for a
    CUDA x, ``F.batch_norm`` for a CPU one. ``bn`` must be affine, track
    running statistics and have a momentum (every BatchNorm of the port's
    residual blocks does). A CUDA x is read in place where it is
    channels-last (4-D) or contiguous; any other is copied once, 4-D to
    channels-last."""
    if bn.weight is None or bn.running_mean is None or bn.momentum is None:
        raise ValueError("batch_norm_train: the BatchNorm must be affine, track running "
                         "statistics and have a momentum")
    bn.num_batches_tracked.add_(1)
    if not x.is_cuda:
        return Fn.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, True,
                             bn.momentum, bn.eps)
    x = readable(x, x.dim() == 4 and not x.is_contiguous())
    return _CudaBatchNorm.apply(x, bn.weight, bn.bias, bn.running_mean, bn.running_var,
                                bn.eps, bn.momentum)
