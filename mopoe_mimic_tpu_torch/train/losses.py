"""The objective: reconstruction log-probabilities, subset KLDs and the
method's total loss.

Port of ``mopoe_mimic_tpu/train/losses.py``. Log-probabilities and KLDs
are summed over every element and divided by the *configured* batch size,
not the runtime batch (mimic/modalities/Modality.py:25-30, kl_div.py:14-15
of the reference). The PoE objective's unimodal ELBOs need extra forwards
and are assembled in ``train/step.py``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.models.resblocks import at_least_f32
from mopoe_mimic_tpu_torch.ops.distributions import (
    bernoulli_log_prob,
    laplace_log_prob,
    normal_log_prob,
    one_hot_categorical_log_prob,
)
from mopoe_mimic_tpu_torch.ops.kl import kl_divergence
from mopoe_mimic_tpu_torch.ops.texthead import TextHeadInputs, fused_text_logprob

IMG_FIXED_SCALE = 0.75  # ConvNetworksImgMimic.py:54

Posterior = Tuple[torch.Tensor, torch.Tensor]


def modality_log_prob(cfg, name: str, rec, target: torch.Tensor) -> torch.Tensor:
    """log p(x_m | z), summed over all elements, / cfg.batch_size.

    Text takes three forms: ``TextHeadInputs`` (the fused vocab head,
    cfg.fused_text_head), word log-probabilities [B, L, V] (the target's
    entry is gathered), or char one-hot targets against logits."""
    if name == "text":
        if isinstance(rec, TextHeadInputs):
            lp = fused_text_logprob(rec.h, rec.kernel, rec.bias, target)
        elif cfg.text_encoding == "word":
            target = target.squeeze(-1) if target.dim() == 3 else target
            log_norm = torch.log_softmax(at_least_f32(rec), dim=-1)
            lp = torch.gather(log_norm, -1, target.long().unsqueeze(-1)).squeeze(-1)
        else:
            lp = one_hot_categorical_log_prob(target, at_least_f32(rec))
    else:
        lik = cfg.likelihoods[name]
        if lik == "laplace":
            lp = laplace_log_prob(target, at_least_f32(rec), IMG_FIXED_SCALE)
        elif lik == "normal":
            lp = normal_log_prob(target, at_least_f32(rec), IMG_FIXED_SCALE)
        elif lik == "bernoulli":
            lp = bernoulli_log_prob(target, at_least_f32(rec))
        else:
            raise NotImplementedError(lik)
    return torch.sum(lp) / float(cfg.batch_size)


def calc_log_probs(cfg, rec: Mapping[str, object], batch: Mapping[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """({modality: −log p}, Σ rec_weight_m · (−log p_m))."""
    log_probs: Dict[str, torch.Tensor] = {}
    weighted = 0.0
    for m in rec:
        log_probs[m] = -modality_log_prob(cfg, m, rec[m], batch[m])
        weighted = weighted + cfg.rec_weights[m] * log_probs[m]
    return log_probs, weighted


def calc_klds(cfg, subsets: Mapping[str, Posterior]) -> Dict[str, torch.Tensor]:
    """KL(q_S ‖ N(0, I)) of every subset posterior."""
    return {key: kl_divergence(mu, lv, norm_value=cfg.batch_size)
            for key, (mu, lv) in subsets.items()}


def calc_klds_style(cfg, styles: Mapping[str, Posterior]) -> Dict[str, torch.Tensor]:
    return {m: kl_divergence(mu, lv, norm_value=cfg.batch_size) for m, (mu, lv) in styles.items()}


def calc_style_kld(cfg, klds_style: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Σ style_weight_m · KL_style_m."""
    total = 0.0
    for m, kld in klds_style.items():
        total = total + cfg.style_weights[m] * kld
    return total


def calc_joint_elbo_loss(cfg, weighted_log_prob: torch.Tensor, group_divergence: torch.Tensor,
                         klds_style: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """weighted −log p + β·(β_style·style KL + β_content·joint divergence),
    the loss of moe, jsd and joint_elbo."""
    kld_style = (calc_style_kld(cfg, klds_style)
                 if (cfg.factorized_representation and klds_style) else 0.0)
    kld_weighted = cfg.beta_style * kld_style + cfg.beta_content * group_divergence
    return weighted_log_prob + cfg.beta * kld_weighted


def calc_elbo(cfg, modality: str, recs: Mapping[str, torch.Tensor], kld_content: torch.Tensor,
              klds_style: Optional[Mapping[str, torch.Tensor]] = None) -> torch.Tensor:
    """A modality's or the joint's ELBO (mimic/utils/utils.py:105-127);
    ``recs`` holds negative log-probabilities."""
    if modality == "joint":
        kld_style = 0.0
        rec_err = 0.0
        for m in recs:
            if cfg.factorized_representation and klds_style:
                kld_style = kld_style + cfg.style_weights[m] * klds_style[m]
            rec_err = rec_err + cfg.rec_weights[m] * recs[m]
    else:
        kld_style = (cfg.style_weights[modality] * klds_style[modality]
                     if (cfg.factorized_representation and klds_style) else 0.0)
        rec_err = 1.0 * recs[modality]
    div = cfg.beta_content * kld_content + cfg.beta_style * kld_style
    return rec_err + cfg.beta * div
