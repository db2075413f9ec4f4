"""Pre-activation residual conv blocks, 1-D and 2-D, conv and transpose.

Port of ``mopoe_mimic_tpu/models/resblocks.py`` with PyTorch's native
layers, which are what the JAX package's ``TorchBatchNorm`` and
``TorchConvTranspose`` emulate. Each block is
BN → ReLU → 1×1 conv → dropout → BN → ReLU → k×k (transpose) conv →
dropout, combined as ``a · shortcut(x) + b · out`` where the shortcut is a
(transpose) conv with bias followed by BN (resblocks.py:320-350 and
:359-393). Attribute names are the reference's, so the keys read
``bn1``, ``conv1``, ``bn2``, ``conv2`` and ``downsample.{0,1}`` /
``upsample.{0,1}``.

``bn_dtype`` (``cfg.bn_compute_dtype``, resolved by ``bn_dtype_of``) is the
dtype each BatchNorm takes its input in, and so the dtype of its normalize,
affine and output: by default float32 whatever the autocast dtype (the
input cast up by ``at_least_f32``: a float64 model, the port's oracle runs,
stays float64), and autocast then lowers only the convolutions. Under
``"compute"`` with bfloat16 autocast each BN takes and gives bfloat16, with
float32 weight and bias; its batch and running statistics stay float32
(resblocks.py:227-255 of the JAX package), and so does the weight's
gradient. It then differs from JAX in its rounding: PyTorch's BatchNorm
normalizes in float32 and rounds once to bfloat16, where JAX rounds after
each bfloat16 operation of the normalize and the affine. (On the card
PyTorch runs a bfloat16 BatchNorm on ATen's own CUDA kernels, not on
cuDNN's, which the float32 one uses; in train mode the port runs its own,
below.) A block's output ``a · residual + b · h`` is then bfloat16, and so
is the next block's input.

On the card a train-mode BatchNorm whose input is bfloat16 (``bn1``, ``bn2``
and the shortcut's under ``"compute"``) runs the port's own kernels
(``ops/batchnorm.batch_norm_train``, ``csrc/batchnorm.cu``) on the module's
parameters and buffers, with ATen's arithmetic; every other BatchNorm (a
CPU tensor, a float32 input, eval mode) is the module's call
(``batch_norm``).

``fused_pointwise=True`` (``cfg.fused_pointwise``, resblocks.py:275-311 of
the JAX package) computes ``bn1 → relu → conv1`` in train mode as one fused
op on the same parameters (``ops/pointwise.py``: the CUDA kernels K3 on the
card, the plain versions on the CPU), which also advances ``bn1``'s running
statistics as ``nn.BatchNorm`` would; it normalizes in float32 whatever
``bn_dtype``, as the Pallas op does. Eval mode runs the modules, ``bn1``'s
output, and so the ReLU, in ``bn_dtype`` (resblocks.py:289 of the JAX
package). The parameter keys do not change.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mopoe_mimic_tpu_torch.ops.batchnorm import batch_norm_train
from mopoe_mimic_tpu_torch.ops.pointwise import conv1x1_matrix, fused_bn_relu_pointwise

A_SKIP, B_SKIP = 2.0, 0.3


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or left in float64."""
    return x if x.dtype == torch.float64 else x.float()


def bn_input(x: torch.Tensor, bn_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """x in the dtype a BatchNorm of ``bn_dtype`` takes: float32 (float64
    left as is) for None or float32, else ``bn_dtype``."""
    if bn_dtype is None or bn_dtype == torch.float32:
        return at_least_f32(x)
    return x.to(bn_dtype)


_FLOAT_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float32": torch.float32, "float64": torch.float64}


def bn_dtype_of(cfg) -> torch.dtype:
    """``cfg.bn_compute_dtype`` as a dtype (mmvae.py:60 of the JAX package):
    ``"compute"`` is the compute dtype, any other value a float dtype's
    name."""
    name = cfg.compute_dtype if cfg.bn_compute_dtype == "compute" else cfg.bn_compute_dtype
    if name not in _FLOAT_DTYPES:
        raise ValueError(f"bn_compute_dtype={cfg.bn_compute_dtype!r} (compute_dtype="
                         f"{cfg.compute_dtype!r}): not a float dtype of {sorted(_FLOAT_DTYPES)}")
    return _FLOAT_DTYPES[name]


def takes_bn_kernels(x: torch.Tensor, bn: nn.Module) -> bool:
    """Whether ``batch_norm`` runs ``bn`` on x through the port's kernels:
    x bfloat16 on a CUDA device and ``bn`` in train mode."""
    return bn.training and x.device.type == "cuda" and x.dtype == torch.bfloat16


def batch_norm(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)``, through the port's kernels where ``takes_bn_kernels``."""
    return batch_norm_train(x, bn) if takes_bn_kernels(x, bn) else bn(x)


def compute_dtype_of(x: torch.Tensor) -> torch.dtype:
    """The dtype autocast would run a conv on x in: the autocast dtype where
    autocast is on for x's device, else x's own."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype


class _ResidualBlock(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 4,
        stride: int = 2,
        padding: int = 1,
        output_padding: int = 0,
        *,
        spatial: int,
        transpose: bool,
        conv_bias: bool,
        a: float = A_SKIP,
        b: float = B_SKIP,
        dropout: float = 0.5,
        bn_eps: float = 1e-5,
        fused_pointwise: bool = False,
        bn_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.fused_pointwise, self.transpose = fused_pointwise, transpose
        self.bn_dtype = bn_dtype
        bn = nn.BatchNorm2d if spatial == 2 else nn.BatchNorm1d
        if transpose:
            conv = nn.ConvTranspose2d if spatial == 2 else nn.ConvTranspose1d
            extra = {"output_padding": output_padding}
        else:
            conv = nn.Conv2d if spatial == 2 else nn.Conv1d
            extra = {}
        # torch Dropout2d zeroes whole feature maps (the 2-D reference
        # blocks); the 1-D blocks use elementwise dropout
        drop = nn.Dropout2d if spatial == 2 else nn.Dropout
        self.a, self.b = a, b
        self.bn1 = bn(in_channels, eps=bn_eps)
        self.conv1 = conv(in_channels, in_channels, 1, 1, 0, bias=conv_bias)
        self.dropout1 = drop(dropout)
        self.bn2 = bn(in_channels, eps=bn_eps)
        self.conv2 = conv(in_channels, out_channels, kernel_size, stride, padding,
                          bias=conv_bias, **extra)
        self.dropout2 = drop(dropout)
        shortcut = nn.Sequential(
            conv(in_channels, out_channels, kernel_size, stride, padding, bias=True, **extra),
            bn(out_channels, eps=bn_eps),
        )
        self._shortcut_name = "upsample" if transpose else "downsample"
        setattr(self, self._shortcut_name, shortcut)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """bn1 → relu → conv1: fused in train mode under ``fused_pointwise``."""
        if not (self.fused_pointwise and self.training):
            return self.conv1(torch.relu(batch_norm(self.bn1, bn_input(x, self.bn_dtype))))
        bn = self.bn1
        y, _, _ = fused_bn_relu_pointwise(
            x, bn.weight, bn.bias, conv1x1_matrix(self.conv1.weight, self.transpose),
            self.conv1.bias, bn.eps, compute_dtype_of(x),
            running=(bn.running_mean, bn.running_var, bn.momentum))
        bn.num_batches_tracked.add_(1)
        return y

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout1(self._head(x))
        h = self.conv2(torch.relu(batch_norm(self.bn2, bn_input(h, self.bn_dtype))))
        h = self.dropout2(h)
        conv, bn = getattr(self, self._shortcut_name)
        residual = batch_norm(bn, bn_input(conv(x), self.bn_dtype))
        return self.a * residual + self.b * h


class ResidualBlock2dConv(_ResidualBlock):
    def __init__(self, in_channels, out_channels, kernel_size=4, stride=2, padding=1, *,
                 conv_bias=False, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         spatial=2, transpose=False, conv_bias=conv_bias, **kw)


class ResidualBlock2dTransposeConv(_ResidualBlock):
    def __init__(self, in_channels, out_channels, kernel_size=4, stride=2, padding=1,
                 output_padding=0, *, conv_bias=False, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, spatial=2, transpose=True, conv_bias=conv_bias, **kw)


class ResidualBlock1dConv(_ResidualBlock):
    def __init__(self, in_channels, out_channels, kernel_size=4, stride=2, padding=1, *,
                 conv_bias=True, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         spatial=1, transpose=False, conv_bias=conv_bias, **kw)


class ResidualBlock1dTransposeConv(_ResidualBlock):
    def __init__(self, in_channels, out_channels, kernel_size=4, stride=2, padding=1,
                 output_padding=0, *, conv_bias=True, **kw):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding,
                         output_padding, spatial=1, transpose=True, conv_bias=conv_bias, **kw)


def block(module: nn.Module) -> nn.Sequential:
    """Wrap a block at index 0, as the reference's factories do
    (keys ``resblock_K.0.*``)."""
    return nn.Sequential(module)
