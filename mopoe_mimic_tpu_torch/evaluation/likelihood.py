"""Importance-weighted (IWAE) log-likelihood estimates per subset
(``mopoe_mimic_tpu/evaluation/likelihood.py``; reference
mimic/evaluation/eval_metrics/likelihood.py:17-129 and
mimic/utils/likelihood.py:82-220): for each subset posterior q_S, draw
``num_imp_samples`` (K, default 6) latents per datapoint, decode every
modality, and estimate

    log p(x_m)     = mean_B[ logmeanexp_K( log p(x_m|z) + log p(z) − log q_S(z|x) ) ]
    log p(x_joint) likewise with Σ_m log p(x_m|z).

The K samples ride the batch axis, K-major: row k·B + b is sample k of
datapoint b, and the weights regroup by ``reshape(K, B).T`` (PARITY.md:122:
the reference's B-major regrouping is a bug not reproduced). Inference runs
once a batch (K1's forward on the card) and feeds every subset's estimate;
the decodes run in eval mode under the compute dtype's autocast, the
log-probabilities in float32. The sums stay on the device until the last
batch. Factorized (style) representations are not ported: the model
refuses style dims, and the estimator raises where the JAX one would take
its style branch.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence

import torch

from mopoe_mimic_tpu_torch.models.resblocks import at_least_f32
from mopoe_mimic_tpu_torch.ops.distributions import laplace_log_prob, one_hot_categorical_log_prob
from mopoe_mimic_tpu_torch.train.losses import IMG_FIXED_SCALE
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device

LOG2PI = math.log(2.0 * math.pi)
SEED_OFFSET = 31  # the estimate's generator is seeded cfg.seed + 31 (likelihood.py:195)


def gaussian_log_pdf(x, mu, logvar):
    return torch.sum(-0.5 * LOG2PI - logvar / 2.0 - (x - mu) ** 2 / (2.0 * torch.exp(logvar)),
                     dim=-1)


def unit_gaussian_log_pdf(x):
    return torch.sum(-0.5 * LOG2PI - x ** 2 / 2.0, dim=-1)


def log_mean_exp(x, dim: int):
    m = torch.amax(x, dim=dim, keepdim=True)
    return m + torch.log(torch.mean(torch.exp(x - m), dim=dim, keepdim=True))


def _mod_log_prob(cfg, name: str, rec, target):
    """A modality's elementwise log-probability summed per sample → [N]."""
    rec = at_least_f32(rec)
    if name == "text":
        if cfg.text_encoding == "word":
            # the target token's log-probability (no [N, L, vocab] one-hot)
            log_norm = torch.log_softmax(rec, dim=-1)
            lp = torch.gather(log_norm, -1, target.long().unsqueeze(-1)).squeeze(-1)
        else:
            lp = one_hot_categorical_log_prob(target, rec)
    else:
        lp = laplace_log_prob(target, rec, IMG_FIXED_SCALE)
    return torch.sum(lp.reshape(lp.shape[0], -1), dim=1)


def _repeat(a: torch.Tensor, n_imp: int) -> torch.Tensor:
    """[B, ...] → [K·B, ...], K-major (row k·B + b is a[b])."""
    return a.repeat(n_imp, *([1] * (a.dim() - 1)))


def _subset_estimate(cfg, model, latents, batch: Mapping[str, torch.Tensor], subset_key: str,
                     n_imp: int, generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The IWAE estimate of every modality and the joint for one subset,
    from shared inference outputs; the noise from ``generator``, or the
    injected ``eps`` [K·B, D]."""
    if cfg.factorized_representation and any(cfg.style_dims[m] for m in cfg.modality_names):
        raise NotImplementedError("the style terms of the likelihood (factorized "
                                  "representations) are not ported (ROADMAP queue 1 item 13)")
    mu, logvar = latents["subsets"][subset_key]
    b = mu.shape[0]
    mu_rep, lv_rep = _repeat(mu, n_imp), _repeat(logvar, n_imp)
    if eps is None:
        eps = torch.randn(mu_rep.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    z = mu_rep + eps * torch.exp(0.5 * lv_rep)
    content_term = unit_gaussian_log_pdf(z) - gaussian_log_pdf(z, mu_rep, lv_rep)

    out: Dict[str, torch.Tensor] = {}
    log_px_sum = 0.0
    for m in cfg.modality_names:
        log_px = _mod_log_prob(cfg, m, model.decoder(m)(z), _repeat(batch[m], n_imp))
        log_px_sum = log_px_sum + log_px
        lw = (log_px + content_term).reshape(n_imp, b).T  # [B, K]
        out[m] = torch.mean(log_mean_exp(lw, dim=1))
    lw_joint = (log_px_sum + content_term).reshape(n_imp, b).T
    out["joint"] = torch.mean(log_mean_exp(lw_joint, dim=1))
    return out


def make_likelihood_fn(cfg, model, subset_keys: Sequence[str]):
    """``estimate(batch, generator=None, eps=None) -> {subset: {modality:
    ll, "joint": ll}}`` (0-d tensors on the device) for every subset:
    inference once, its posteriors feeding each subset's estimate in turn
    (the reference computes the latents once a batch too,
    likelihood.py:113-118). ``eps``: {subset: [K·B, D]} injected noise. The
    caller sets the mode (``eval_mode``)."""
    n_imp = cfg.num_imp_samples
    keys = tuple(subset_keys)

    def estimate(batch, generator=None, eps: Optional[Mapping[str, torch.Tensor]] = None):
        latents = model.inference(batch)
        return {s: _subset_estimate(cfg, model, latents, batch, s, n_imp, generator,
                                    None if eps is None else eps[s]) for s in keys}

    return estimate


def estimate_likelihoods(exp, state, max_batches: int = 0) -> Dict[str, Dict[str, float]]:
    """Each subset's IWAE estimates averaged over the test set's batches
    (estimate_likelihoods, likelihood.py:94-129); ``max_batches`` > 0 caps
    the batches."""
    cfg, model = exp.cfg, state.model
    param = next(model.parameters())
    generator = torch.Generator(param.device).manual_seed((cfg.seed or 0) + SEED_OFFSET)
    estimate = make_likelihood_fn(cfg, model, list(exp.subsets))
    sums, count = None, 0
    with eval_mode(cfg, model):
        for i, (batch, _labels) in enumerate(exp.eval_batches("test")):
            if max_batches and i >= max_batches:
                break
            vals = estimate(to_device(batch, param), generator)
            flat = torch.stack([v for d in vals.values() for v in d.values()]).double()
            sums = flat if sums is None else sums + flat
            count += 1
    names = [(s, m) for s in exp.subsets for m in [*cfg.modality_names, "joint"]]
    totals = sums.tolist() if sums is not None else [0.0] * len(names)
    out: Dict[str, Dict[str, float]] = {s: {} for s in exp.subsets}
    for (s, m), v in zip(names, totals):
        out[s][m] = v / max(count, 1)
    return out
