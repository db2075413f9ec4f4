"""KL divergences and the joint divergences of the four methods.

Port of ``mopoe_mimic_tpu/ops/kl.py:27-116`` (reference kl_div.py:8-16,
mm_div.py:67-110): sums over every element, divided by a normalisation
value (the configured batch size, not the runtime batch). The mixture
lb/ub bounds (kl.py:133-187) are evaluation code and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops.fusion import alpha_poe


def kl_divergence(mu0: torch.Tensor, logvar0: torch.Tensor,
                  mu1: Optional[torch.Tensor] = None, logvar1: Optional[torch.Tensor] = None,
                  norm_value: Optional[float] = None) -> torch.Tensor:
    """KL(N(mu0, var0) ‖ N(mu1, var1)), N(0, I) when mu1 is None; a scalar
    summed over every element, divided by ``norm_value`` when given."""
    return kl_divergence_batched(mu0, logvar0, mu1, logvar1, norm_value, dims=None)


def kl_divergence_batched(mu0: torch.Tensor, logvar0: torch.Tensor,
                          mu1: Optional[torch.Tensor] = None,
                          logvar1: Optional[torch.Tensor] = None,
                          norm_value: Optional[float] = None,
                          dims: Optional[Tuple[int, ...]] = (-2, -1)) -> torch.Tensor:
    """KL per leading-axis component: [K, B, D] → [K] (``dims=None`` sums
    everything)."""
    if mu1 is None or logvar1 is None:
        terms = 1.0 - torch.exp(logvar0) - mu0 ** 2 + logvar0
    else:
        var_ratio = torch.exp(logvar0 - logvar1)
        terms = (1.0 - var_ratio - (mu0 - mu1) ** 2 / torch.exp(logvar1)
                 + logvar0 - logvar1)
    kld = -0.5 * (torch.sum(terms) if dims is None else torch.sum(terms, dim=dims))
    if norm_value is not None:
        kld = kld / float(norm_value)
    return kld


def group_divergence_moe(mus: torch.Tensor, logvars: torch.Tensor, weights: torch.Tensor,
                         normalization: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-prior joint divergence Σ_k w_k · KL(q_k ‖ N(0, I)) over
    [K, B, D]; returns (divergence, per-component klds [K])."""
    klds = kl_divergence_batched(mus, logvars, norm_value=normalization)
    return torch.sum(weights.to(klds.dtype) * klds), klds


def alpha_jsd_divergence(mus: torch.Tensor, logvars: torch.Tensor, weights: torch.Tensor,
                         normalization: Optional[float] = None):
    """Dynamic-prior (JSD) joint divergence: each component's KL against the
    alpha-PoE of all components. Returns (divergence, klds [K],
    (alpha_mu, alpha_logvar))."""
    alpha_mu, alpha_logvar = alpha_poe(weights, mus, logvars)
    klds = kl_divergence_batched(mus, logvars, alpha_mu.expand_as(mus),
                                 alpha_logvar.expand_as(logvars), norm_value=normalization)
    return torch.sum(weights.to(klds.dtype) * klds), klds, (alpha_mu, alpha_logvar)
