"""DenseNet-121 as the VAE's X-ray feature extractor
(``feature_extractor_img="densenet"``), NCHW.

Port of ``mopoe_mimic_tpu/models/densenet.py:24-142`` (reference
mimic/networks/CheXNet.py:85-106, ConvNetworksImgMimic.py:10-17): Huang et
al., "Densely Connected Convolutional Networks" (arXiv:1608.06993),
DenseNet-BC with growth 32 and dense blocks of 6, 12, 24 and 16 layers,
torchvision's ``densenet121``:

  * stem: the grayscale input repeated to 3 channels, a 7×7/2 conv to 64,
    BN, ReLU, a 3×3/2 max pool;
  * dense layer: BN → ReLU → 1×1 conv to 128 → BN → ReLU → 3×3 conv to 32,
    its output concatenated onto every earlier feature map of its block;
  * transition: BN → ReLU → a 1×1 conv that halves the channels → 2×2
    average pool;
  * head: BN, ReLU and a global average pool to 1024; the VAE's ``proj``,
    a linear layer from 1024 to 5·DIM_img.

Every conv is bias-free; every BatchNorm has eps 1e-5 and momentum 0.1.
The keys are torchvision's (``features.conv0``, ``features.norm0``,
``features.denseblockB.denselayerL.{norm1,conv1,norm2,conv2}``,
``features.transitionT.{norm,conv}``, ``features.norm5``), then ``proj``.

Every BatchNorm takes its input in ``bn_dtype`` (``cfg.bn_compute_dtype``)
and goes through ``models/resblocks.batch_norm``: in train mode on the
card under ``"compute"`` with bfloat16 autocast, the port's own bfloat16
kernels. This departs from the JAX module, which fixes its DenseNet
BatchNorms at float32 whatever the configuration; the port follows the
configuration's key, as its residual blocks do. A float32 model is the
same on both sides.

``fixed_extractor`` (``cfg.fixed_image_extractor``) gives the trunk's
parameters no gradient (``requires_grad`` off, as the reference's
CheXNet.py:23-25 does; the JAX module stops the gradient at the trunk's
output, which leaves the same zero gradients); its BatchNorm statistics
still update in train mode, and ``proj`` trains.

The span ``densenet.trunk`` times each trunk's forward (on the host: the
eager paths and a graph's capture). ``COUNTS`` holds ``densenet.layers``,
the dense layers run, and ``densenet.concat_bytes``, the bytes their
concatenations read and write; as the kernels' ``LAUNCHES``, a capture's
counts are taken out and each replay adds them (``ops/_build.uncounted``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn.functional as Fn
from torch import nn

from mopoe_mimic_tpu_torch.models.resblocks import batch_norm, bn_input
from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.utils import profiling

GROWTH = 32
BOTTLENECK = 4 * GROWTH  # the 1×1 conv's width
BLOCK_CONFIG = (6, 12, 24, 16)
STEM = 64
FEATURES = 1024  # the trunk's output: STEM + 32·Σ layers, halved at each transition
BN_EPS, BN_MOMENTUM = 1e-5, 0.1

COUNTS = _build.launch_counts("densenet.layers", "densenet.concat_bytes")


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class _DenseLayer(nn.Module):
    def __init__(self, in_channels: int, bn_dtype: Optional[torch.dtype]):
        super().__init__()
        self.bn_dtype = bn_dtype
        self.norm1 = _bn(in_channels)
        self.conv1 = nn.Conv2d(in_channels, BOTTLENECK, 1, bias=False)
        self.norm2 = _bn(BOTTLENECK)
        self.conv2 = nn.Conv2d(BOTTLENECK, GROWTH, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(torch.relu(batch_norm(self.norm1, bn_input(x, self.bn_dtype))))
        h = self.conv2(torch.relu(batch_norm(self.norm2, bn_input(h, self.bn_dtype))))
        out = torch.cat([x, h], 1)
        COUNTS["densenet.layers"] += 1
        COUNTS["densenet.concat_bytes"] += 2 * out.numel() * out.element_size()
        return out


def _dense_block(n_layers: int, in_channels: int,
                 bn_dtype: Optional[torch.dtype]) -> nn.Sequential:
    return nn.Sequential(OrderedDict(
        (f"denselayer{i + 1}", _DenseLayer(in_channels + i * GROWTH, bn_dtype))
        for i in range(n_layers)))


class _Transition(nn.Module):
    def __init__(self, in_channels: int, bn_dtype: Optional[torch.dtype]):
        super().__init__()
        self.bn_dtype = bn_dtype
        self.norm = _bn(in_channels)
        self.conv = nn.Conv2d(in_channels, in_channels // 2, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(torch.relu(batch_norm(self.norm, bn_input(x, self.bn_dtype))))
        return Fn.avg_pool2d(h, 2, 2)


class DenseNet121(nn.Module):
    """[B, 1 or 3, H, W] → [B, 1024] (after the global average pool)."""

    def __init__(self, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.bn_dtype = bn_dtype
        self.conv0 = nn.Conv2d(3, STEM, 7, 2, 3, bias=False)
        self.norm0 = _bn(STEM)
        channels = STEM
        for b, n_layers in enumerate(BLOCK_CONFIG, start=1):
            setattr(self, f"denseblock{b}", _dense_block(n_layers, channels, bn_dtype))
            channels += n_layers * GROWTH
            if b < len(BLOCK_CONFIG):
                setattr(self, f"transition{b}", _Transition(channels, bn_dtype))
                channels //= 2
        self.norm5 = _bn(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("densenet.trunk"):
            if x.shape[1] == 1:
                x = x.expand(-1, 3, -1, -1)  # grayscale → the RGB stem
            h = self.conv0(x)
            h = torch.relu(batch_norm(self.norm0, bn_input(h, self.bn_dtype)))
            h = Fn.max_pool2d(h, 3, 2, 1)
            for b in range(1, len(BLOCK_CONFIG) + 1):
                h = getattr(self, f"denseblock{b}")(h)
                if b < len(BLOCK_CONFIG):
                    h = getattr(self, f"transition{b}")(h)
            h = torch.relu(batch_norm(self.norm5, bn_input(h, self.bn_dtype)))
            return h.mean(dim=(2, 3))


class DenseNetFeatureExtractor(nn.Module):
    """The trunk → ``proj`` (1024 → ``out_features``): [B, C, H, W] →
    [B, out_features], interchangeable with the residual extractor's
    [B, 5·dim]."""

    def __init__(self, out_features: int, fixed_extractor: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = DenseNet121(bn_dtype)
        if fixed_extractor:
            self.features.requires_grad_(False)
        self.proj = nn.Linear(FEATURES, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(self.features(x))
