"""Reparameterized Gaussian sampling (mimic/utils/utils.py:45-48)."""

from __future__ import annotations

from typing import Optional, Union

import torch


def reparameterize(
    mu: torch.Tensor,
    logvar: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    eps: Optional[Union[torch.Tensor, float]] = None,
) -> torch.Tensor:
    """z = mu + eps * exp(logvar / 2). eps ~ N(0, 1) from ``generator``
    (which must live on mu's device), or the injected ``eps`` when given."""
    std = torch.exp(0.5 * logvar)
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + eps * std
