"""Image encoder/decoder for the X-ray modalities (PA, Lateral), NCHW at
their public functions.

Port of the resnet path of ``mopoe_mimic_tpu/models/img_networks.py``
(reference FeatureExtractorImg.py, DataGeneratorImg.py,
ConvNetworksImgMimic.py) at 64, 128 and 256 px. 2-D blocks have no conv
bias; the shortcut convs do; the stem ``conv1`` has none; the output
``ConvTranspose2d(k3, s2, p1, output_padding 1)`` has one.
``fused_pointwise`` and ``bn_dtype`` go to every residual block
(img_networks.py:45-207 of the JAX package). The encoder's feature
extractor is the residual stack or DenseNet-121 (``feature_extractor``,
``cfg.feature_extractor_img``; ``models/densenet.py``), which takes
``bn_dtype`` and ``fixed_extractor`` and no ``fused_pointwise``, as the
JAX package's takes none.

``channels_last`` (``MMVae`` decides it) keeps a network's conv weights and
every 4-D activation in ``torch.channels_last``: the stem gives its output
in that layout (DenseNet's conv0: cuDNN converts the input once), and each
op after keeps it. Logical shapes stay NCHW, and parameter keys and values
are the same in either layout. There the resnet encoder's stem (one image
channel in) and the decoder's output layer (one out) run as a matrix
product over the input's patches (``conv2d_rows``,
``conv_transpose2d_rows``): cuDNN's channels-last kernels take a single
image channel 2-4 times as long as its NCHW ones at these shapes (PERF.md,
Findings), the product a fraction of either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as Fn
from torch import nn

from mopoe_mimic_tpu_torch.models.compressor import LinearFeatureCompressor
from mopoe_mimic_tpu_torch.models.densenet import DenseNetFeatureExtractor
from mopoe_mimic_tpu_torch.models.resblocks import (
    ResidualBlock2dConv,
    ResidualBlock2dTransposeConv,
    block,
)

IMG_SIZES = (64, 128, 256)


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv(x)`` as x's patches [B·L, Ci·kh·kw] times the weight's
    transpose: the output [B, Co, Ho, Wo] channels-last. ``conv`` has no
    bias, dilation or groups (the stem)."""
    B, Ci, H, W = x.shape
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    Ho, Wo = (H + 2 * ph - kh) // sh + 1, (W + 2 * pw - kw) // sw + 1
    # the batch as channels of one sample: ATen's unfold launches a kernel a sample
    cols = Fn.unfold(x.reshape(1, B * Ci, H, W), conv.kernel_size, padding=conv.padding,
                     stride=conv.stride).view(B, Ci * kh * kw, Ho * Wo)
    out = cols.transpose(1, 2) @ conv.weight.reshape(conv.out_channels, -1).t()
    return out.view(B, Ho, Wo, conv.out_channels).permute(0, 3, 1, 2)


class _TransposedRows(torch.autograd.Function):
    """The taps [B, Co·kh·kw, H·W] of a channels-last h [B, Ci, H, W]
    under w [Ci, Co·kh·kw], both ways as products of h's rows in place (a
    batched product with h's [H·W, Ci] rows as the transposed operand): no
    copy of h forward, a channels-last gradient backward."""

    @staticmethod
    def forward(ctx, h, w):
        B, C, H, W = h.shape
        rows = h.permute(0, 2, 3, 1).reshape(B, H * W, C)  # a view of channels-last memory
        ctx.save_for_backward(rows, w)
        ctx.shape = h.shape
        return torch.matmul(w.t(), rows.transpose(1, 2))

    @staticmethod
    def backward(ctx, g):
        rows, w = ctx.saved_tensors
        B, C, H, W = ctx.shape
        dh = torch.matmul(g.transpose(1, 2), w.t()) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:  # one product over every row: float32 sums inside
            dw = rows.reshape(B * H * W, C).t() @ g.transpose(1, 2).reshape(B * H * W, -1)
        return None if dh is None else dh.view(B, H, W, C).permute(0, 3, 1, 2), dw


def conv_transpose2d_rows(h: torch.Tensor, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """``conv(h)`` for a channels-last h: h's rows [B·H·W, Ci] times the
    weight [Ci, Co·kh·kw], each row's taps added into the output by
    ``fold`` (the transposed convolution's scatter). ``conv`` has no
    dilation or groups, and its output padding is below its stride."""
    B, C, H, W = h.shape
    (kh, kw), (sh, sw), (ph, pw) = conv.kernel_size, conv.stride, conv.padding
    oph, opw = conv.output_padding
    Ho, Wo = (H - 1) * sh - 2 * ph + kh + oph, (W - 1) * sw - 2 * pw + kw + opw
    Co = conv.out_channels
    w = conv.weight.reshape(C, Co * kh * kw)
    if torch.is_autocast_enabled(h.device.type):  # as autocast runs a conv
        dtype = torch.get_autocast_dtype(h.device.type)
        h, w = h.to(dtype), w.to(dtype)
    with torch.autocast(h.device.type, enabled=False):
        taps = _TransposedRows.apply(h, w)  # [B, Co·kh·kw, H·W]
    # the batch as channels of one sample: ATen's fold launches a kernel a sample
    out = Fn.fold(taps.view(1, B * Co * kh * kw, H * W), (Ho, Wo), conv.kernel_size,
                  padding=conv.padding, stride=conv.stride).view(B, Co, Ho, Wo)
    if conv.bias is not None:
        out = out + conv.bias.to(out.dtype).view(1, -1, 1, 1)
    return out


def _check_size(img_size: int) -> None:
    if img_size not in IMG_SIZES:
        raise NotImplementedError(f"img_size {img_size} unsupported (one of {IMG_SIZES})")


class FeatureExtractorImg(nn.Module):
    """[B, C, H, W] → [B, 5·dim] (1×1 spatial)."""

    def __init__(self, dim: int, img_size: int = 128, image_channels: int = 1,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, channels_last: bool = False):
        super().__init__()
        _check_size(img_size)
        self.channels_last = channels_last
        d = dim
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        self.conv1 = nn.Conv2d(image_channels, d, 3, 2, 1, bias=False)
        self.resblock_1 = block(ResidualBlock2dConv(d, 2 * d, 4, 2, 1, **kw))
        self.resblock_2 = block(ResidualBlock2dConv(2 * d, 3 * d, 4, 2, 1, **kw))
        self.resblock_3 = block(ResidualBlock2dConv(3 * d, 4 * d, 4, 2, 1, **kw))
        if img_size == 64:
            self.resblock_4 = block(ResidualBlock2dConv(4 * d, 5 * d, 4, 2, 0, **kw))
            self.n_blocks = 4
        else:
            stride4 = 4 if img_size == 256 else 2
            self.resblock_4 = block(ResidualBlock2dConv(4 * d, 5 * d, 4, stride4, 1, **kw))
            self.resblock_5 = block(ResidualBlock2dConv(5 * d, 5 * d, 4, 2, 0, **kw))
            self.n_blocks = 5
        if channels_last:
            self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = conv2d_rows(x, self.conv1) if self.channels_last else self.conv1(x)
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"resblock_{i}")(h)
        return h.reshape(h.shape[0], -1)


class DataGeneratorImg(nn.Module):
    """[B, 5·dim, 1, 1] → [B, image_channels, img_size, img_size]."""

    def __init__(self, dim: int, img_size: int = 128, image_channels: int = 1,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, channels_last: bool = False):
        super().__init__()
        _check_size(img_size)
        self.channels_last = channels_last
        d = dim
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        layers = [
            block(ResidualBlock2dTransposeConv(5 * d, 4 * d, 4, 1, 0, **kw)),
            block(ResidualBlock2dTransposeConv(4 * d, 3 * d, 4, 2, 1, **kw)),
            block(ResidualBlock2dTransposeConv(3 * d, 2 * d, 4, 2, 1, **kw)),
            block(ResidualBlock2dTransposeConv(2 * d, 1 * d, 4, 2, 1, **kw)),
        ]
        if img_size >= 128:
            layers.append(block(ResidualBlock2dTransposeConv(d, d, 4, 2, 1, **kw)))
        if img_size == 256:
            layers.append(block(ResidualBlock2dTransposeConv(d, d, 4, 2, 1, **kw)))
        layers.append(nn.ConvTranspose2d(d, image_channels, 3, 2, 1, output_padding=1, bias=True))
        self.generator = nn.Sequential(*layers)
        if channels_last:
            self.to(memory_format=torch.channels_last)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        if not self.channels_last:
            return self.generator(feats)
        h = self.generator[:-1](feats.contiguous(memory_format=torch.channels_last))
        return conv_transpose2d_rows(h, self.generator[-1])


class EncoderImg(nn.Module):
    """Image → (mu, logvar) of the content latent; ``feature_extractor``
    ``"resnet"`` or ``"densenet"`` (img_networks.py:146-151 of the JAX
    package; ``fixed_extractor`` is the DenseNet's alone)."""

    def __init__(self, dim: int, class_dim: int, img_size: int = 128,
                 image_channels: int = 1, bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, feature_extractor: str = "resnet",
                 fixed_extractor: bool = False, channels_last: bool = False):
        super().__init__()
        self.channels_last = channels_last
        if feature_extractor == "densenet":
            self.feature_extractor = DenseNetFeatureExtractor(5 * dim, fixed_extractor, bn_dtype)
            if channels_last:  # conv0 takes the input in as it is, cuDNN converting it once
                self.feature_extractor.to(memory_format=torch.channels_last)
        elif feature_extractor == "resnet":
            self.feature_extractor = FeatureExtractorImg(dim, img_size, image_channels, bn_eps,
                                                         fused_pointwise, bn_dtype, channels_last)
        else:
            raise NotImplementedError(f"feature_extractor_img={feature_extractor!r}: "
                                      "'resnet' or 'densenet'")
        self.feature_compressor = LinearFeatureCompressor(5 * dim, class_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.feature_compressor(self.feature_extractor(x))


class DecoderImg(nn.Module):
    """Content latent → image mean [B, C, H, W] (the Laplace scale 0.75 is
    fixed and applied by the likelihood, ConvNetworksImgMimic.py:54)."""

    def __init__(self, dim: int, class_dim: int, img_size: int = 128,
                 image_channels: int = 1, bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, channels_last: bool = False):
        super().__init__()
        self.channels_last = channels_last
        self.feature_generator = nn.Linear(class_dim, 5 * dim)
        self.img_generator = DataGeneratorImg(dim, img_size, image_channels, bn_eps,
                                              fused_pointwise, bn_dtype, channels_last)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        feats = self.feature_generator(z)
        return self.img_generator(feats.reshape(feats.shape[0], -1, 1, 1))
