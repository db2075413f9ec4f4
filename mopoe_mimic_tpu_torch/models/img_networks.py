"""Image encoder/decoder for the X-ray modalities (PA, Lateral), NCHW.

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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mopoe_mimic_tpu_torch.models.compressor import LinearFeatureCompressor
from mopoe_mimic_tpu_torch.models.densenet import DenseNetFeatureExtractor
from mopoe_mimic_tpu_torch.models.resblocks import (
    ResidualBlock2dConv,
    ResidualBlock2dTransposeConv,
    block,
)

IMG_SIZES = (64, 128, 256)


def _check_size(img_size: int) -> None:
    if img_size not in IMG_SIZES:
        raise NotImplementedError(f"img_size {img_size} unsupported (one of {IMG_SIZES})")


class FeatureExtractorImg(nn.Module):
    """[B, C, H, W] → [B, 5·dim] (1×1 spatial)."""

    def __init__(self, dim: int, img_size: int = 128, image_channels: int = 1,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_size(img_size)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"resblock_{i}")(h)
        return h.reshape(h.shape[0], -1)


class DataGeneratorImg(nn.Module):
    """[B, 5·dim, 1, 1] → [B, image_channels, img_size, img_size]."""

    def __init__(self, dim: int, img_size: int = 128, image_channels: int = 1,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_size(img_size)
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

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return self.generator(feats)


class EncoderImg(nn.Module):
    """Image → (mu, logvar) of the content latent; ``feature_extractor``
    ``"resnet"`` or ``"densenet"`` (img_networks.py:146-151 of the JAX
    package; ``fixed_extractor`` is the DenseNet's alone)."""

    def __init__(self, dim: int, class_dim: int, img_size: int = 128,
                 image_channels: int = 1, bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, feature_extractor: str = "resnet",
                 fixed_extractor: bool = False):
        super().__init__()
        if feature_extractor == "densenet":
            self.feature_extractor = DenseNetFeatureExtractor(5 * dim, fixed_extractor, bn_dtype)
        elif feature_extractor == "resnet":
            self.feature_extractor = FeatureExtractorImg(dim, img_size, image_channels, bn_eps,
                                                         fused_pointwise, bn_dtype)
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
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_generator = nn.Linear(class_dim, 5 * dim)
        self.img_generator = DataGeneratorImg(dim, img_size, image_channels, bn_eps,
                                              fused_pointwise, bn_dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        feats = self.feature_generator(z)
        return self.img_generator(feats.reshape(feats.shape[0], -1, 1, 1))
