"""Gaussian head: features → (mu, logvar) of the content latent.

Port of ``mopoe_mimic_tpu/models/compressor.py`` (reference
mimic/networks/FeatureCompressor.py:4-28). Style heads (factorized
representations) are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class LinearFeatureCompressor(nn.Module):
    def __init__(self, in_features: int, class_dim: int):
        super().__init__()
        self.content_mu = nn.Linear(in_features, class_dim)
        self.content_logvar = nn.Linear(in_features, class_dim)

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = feats.reshape(feats.shape[0], -1)
        return self.content_mu(feats), self.content_logvar(feats)
