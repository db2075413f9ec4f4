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
BatchNorm does. Its plain version, taken for a CPU tensor only, is
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
    """``bn_fwd_cuda`` on x [N, C, *spatial] (contiguous) viewed as
    [N, C, S], and ``bn_bwd_cuda`` from the saved x, mean and invstd: one
    autograd node a BatchNorm, as ATen's."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum):
        y, mean, invstd = cuda_batchnorm.bn_fwd_cuda(_as_3d(x), weight, bias, running_mean,
                                                     running_var, eps, momentum)
        ctx.save_for_backward(x, weight, mean, invstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, invstd = ctx.saved_tensors
        dx, dweight, dbias = cuda_batchnorm.bn_bwd_cuda(_as_3d(x), _as_3d(gy.contiguous()),
                                                        weight, mean, invstd)
        return dx.view(x.shape), dweight, dbias, None, None, None, None


def _as_3d(t: torch.Tensor) -> torch.Tensor:
    return t.view(t.shape[0], t.shape[1], -1)


def batch_norm_train(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm) -> torch.Tensor:
    """``bn(x)`` in train mode for x [N, C, *spatial]: on the kernels for a
    CUDA x, ``F.batch_norm`` for a CPU one. ``bn`` must be affine, track
    running statistics and have a momentum (every BatchNorm of the port's
    residual blocks does)."""
    if bn.weight is None or bn.running_mean is None or bn.momentum is None:
        raise ValueError("batch_norm_train: the BatchNorm must be affine, track running "
                         "statistics and have a momentum")
    bn.num_batches_tracked.add_(1)
    if not x.is_cuda:
        return Fn.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, True,
                             bn.momentum, bn.eps)
    return _CudaBatchNorm.apply(x.contiguous(), bn.weight, bn.bias, bn.running_mean,
                                bn.running_var, bn.eps, bn.momentum)
