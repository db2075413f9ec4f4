"""Elementwise log-probabilities of the decoders' likelihoods.

Port of ``mopoe_mimic_tpu/ops/distributions.py``: the torch.distributions
formulas the reference uses (mimic/modalities/utils.py:4-15), as plain
tensor functions. Reduction and normalisation are the caller's
(``train/losses.py``).
"""

from __future__ import annotations

import math

import torch

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def laplace_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: float) -> torch.Tensor:
    """log Laplace(x; loc, scale); the image decoders' scale is fixed at
    0.75 (ConvNetworksImgMimic.py:54)."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    return -torch.log(2.0 * scale) - torch.abs(x - loc) / scale


def normal_log_prob(x: torch.Tensor, loc: torch.Tensor, scale: float) -> torch.Tensor:
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    var = scale * scale
    return -((x - loc) ** 2) / (2.0 * var) - torch.log(scale) - _HALF_LOG_2PI


def bernoulli_log_prob(x: torch.Tensor, probs: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """log Bernoulli(x; probs), parameterised by probabilities."""
    probs = torch.clamp(probs, eps, 1.0 - eps)
    return x * torch.log(probs) + (1.0 - x) * torch.log1p(-probs)


def one_hot_categorical_log_prob(one_hot_target: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """log OneHotCategorical(target; logits) over the last axis, one value
    per position; the logits are normalised here, as torch does."""
    return torch.sum(one_hot_target * torch.log_softmax(logits, dim=-1), dim=-1)
