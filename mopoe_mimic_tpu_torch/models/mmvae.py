"""The multimodal VAE: encode, subset posteriors and the joint, the joint
divergence and the training forward, generation and conditional
generation.

Port of ``mopoe_mimic_tpu/models/mmvae.py`` (reference BaseMMVae.py and
VAEtrimodalMimic.py). Semantics kept from the JAX module:

  * subsets in powerset order, PoE over each under ``joint_elbo`` / ``poe``
    (``poe`` adds a N(0, I) expert), deterministic mixture selection under
    ``moe`` / ``jsd``;
  * passing subsets: moe/jsd → singletons, poe → the full set,
    joint_elbo → all; jsd appends a N(0, I) component; the joint takes row
    b from a component fixed by the batch size;
  * image decoders emit the Laplace mean, the text decoder log-softmax,
    turned into probabilities by ``generate_from_latents``.

The subset PoE goes through the hand-written CUDA kernels (forward and
backward) when ``cfg.use_pallas_fusion`` is set and the posteriors are on
a CUDA device, which read the encoders' posteriors in place, and through
the plain PyTorch version otherwise, which stacks them (mmvae.py:184-193
of the JAX package). The posteriors are cast to float32 before fusion.
What the JAX package fixes at trace time is built once here and nothing
in ``inference`` waits for the host: the power set and subset mask of each
tuple of modalities (``ops/fusion.subset_layout``) and the kernel's view
of the mask; the subsets that enter the joint, a range of rows
(``ops/fusion.passing_range``); the mixture's row index, on the device
(``ops/fusion.mixture_component_selection``).
``cfg.fused_pointwise`` builds every residual block with the fused BN →
ReLU → 1×1 conv (K3) for train mode (mmvae.py:83, 102, 119, 134), and
``cfg.bn_compute_dtype`` gives every BatchNorm its dtype (mmvae.py:60:
``"compute"`` the compute dtype, else a dtype's name; ``models/resblocks.py``).
``remat`` other than ``"none"`` is refused: nothing is rematerialised.
Factorized (style) representations are not ported yet.

Layouts are PyTorch's for images (NCHW) and the JAX package's for text:
word ids [B, L], or under ``text_encoding="char"`` a float one-hot
[B, 1024, 71]; the text output is [B, L, classes]. The session converts
images at its boundary.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from mopoe_mimic_tpu_torch.config import Method, MopoeConfig
from mopoe_mimic_tpu_torch.models.img_networks import DecoderImg, EncoderImg
from mopoe_mimic_tpu_torch.models.resblocks import at_least_f32, bn_dtype_of
from mopoe_mimic_tpu_torch.models.text_networks import DecoderText, EncoderText
from mopoe_mimic_tpu_torch.ops import fusion as F
from mopoe_mimic_tpu_torch.ops import kl as KL
from mopoe_mimic_tpu_torch.ops.cuda_fusion import poe_subsets_cuda
from mopoe_mimic_tpu_torch.ops.sampling import reparameterize

# modality → the reference's attribute suffix (encoder_pa, decoder_lat, ...)
MODULE_SUFFIX = {"PA": "pa", "Lateral": "lat", "text": "text"}

Posterior = Tuple[torch.Tensor, torch.Tensor]


class MMVae(nn.Module):
    """Trimodal (or text-only) multimodal VAE, inference and generation."""

    def __init__(self, cfg: MopoeConfig):
        super().__init__()
        if cfg.factorized_representation and any(cfg.style_dims.values()):
            raise NotImplementedError("factorized (style) representations are not ported yet")
        if cfg.feature_extractor_img != "resnet":
            raise NotImplementedError("only the resnet image feature extractor is ported")
        if cfg.remat != "none":
            raise NotImplementedError(f"remat={cfg.remat!r} is not ported")
        self.cfg = cfg
        bn_dtype = bn_dtype_of(cfg)
        for m in cfg.modality_names:
            suffix = MODULE_SUFFIX[m]
            if m == "text":
                enc = EncoderText(cfg.DIM_text, cfg.class_dim, cfg.num_features,
                                  cfg.len_sequence, cfg.bn_eps, cfg.fused_pointwise, bn_dtype,
                                  cfg.text_encoding)
                dec = DecoderText(cfg.DIM_text, cfg.class_dim, cfg.num_features,
                                  cfg.len_sequence, cfg.text_gen_lastlayer, cfg.bn_eps,
                                  cfg.fused_pointwise, bn_dtype, cfg.text_encoding)
            else:
                enc = EncoderImg(cfg.DIM_img, cfg.class_dim, cfg.img_size,
                                 cfg.image_channels, cfg.bn_eps, cfg.fused_pointwise, bn_dtype)
                dec = DecoderImg(cfg.DIM_img, cfg.class_dim, cfg.img_size,
                                 cfg.image_channels, cfg.bn_eps, cfg.fused_pointwise, bn_dtype)
            setattr(self, f"encoder_{suffix}", enc)
            setattr(self, f"decoder_{suffix}", dec)

    def encoder(self, modality: str) -> nn.Module:
        return getattr(self, f"encoder_{MODULE_SUFFIX[modality]}")

    def decoder(self, modality: str) -> nn.Module:
        return getattr(self, f"decoder_{MODULE_SUFFIX[modality]}")

    # ------------------------------------------------------------------

    def encode(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, Posterior]:
        """Per-modality posteriors, float32 (float64 in a float64 model),
        for the modalities in ``batch``."""
        content: Dict[str, Posterior] = {}
        for m in self.cfg.modality_names:
            if m in batch:
                mu, lv = self.encoder(m)(batch[m])
                content[m] = (at_least_f32(mu), at_least_f32(lv))
        return content

    def inference(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """Subset posteriors and the joint mixture (mmvae.py:167-244)."""
        cfg = self.cfg
        method = cfg.method_enum
        present = tuple(m for m in cfg.modality_names if m in batch)
        content = self.encode(batch)
        subsets, mask = F.subset_layout(present)
        mus = [content[m][0] for m in present]      # M × [B, D]
        logvars = [content[m][1] for m in present]  # M × [B, D]

        if method.uses_poe_fusion:
            prior = method is Method.POE
            if cfg.use_pallas_fusion and mus[0].is_cuda:  # K1 reads the posteriors in place
                s_mu, s_lv = poe_subsets_cuda(mus, logvars, mask, prior_expert=prior)
            else:
                s_mu, s_lv = F.poe_subsets(mus, logvars, mask, prior_expert=prior)
        else:  # moe / jsd: deterministic mixture within each subset
            per_subset = []
            for members in subsets.values():
                if len(members) == 1:
                    per_subset.append((mus[members[0]], logvars[members[0]]))
                else:
                    per_subset.append(F.mixture_component_selection(
                        torch.stack([mus[m] for m in members]),
                        torch.stack([logvars[m] for m in members]),
                        [1.0 / len(members)] * len(members)))
            s_mu = torch.stack([p[0] for p in per_subset])
            s_lv = torch.stack([p[1] for p in per_subset])

        distr_subsets = {key: (s_mu[i], s_lv[i]) for i, key in enumerate(subsets)}

        # the subsets that enter the joint: one range of rows (a view; the
        # whole of s_mu under joint_elbo)
        start, stop = F.passing_range(present, method)
        j_mus, j_lvs = s_mu, s_lv
        if (start, stop) != (0, len(subsets)):
            j_mus, j_lvs = s_mu[start:stop], s_lv[start:stop]
        if method is Method.JSD:
            zeros = torch.zeros_like(j_mus[:1])
            j_mus = torch.cat([j_mus, zeros])
            j_lvs = torch.cat([j_lvs, zeros])
        k = j_mus.shape[0]
        joint = F.mixture_component_selection(j_mus, j_lvs, [1.0 / k] * k)
        return {
            "modalities": content,
            "subsets": distr_subsets,
            "mus": j_mus,
            "logvars": j_lvs,
            "weights": torch.full((k,), 1.0 / k, device=j_mus.device),
            "joint": joint,
        }

    def joint_divergence(self, mus: torch.Tensor, logvars: torch.Tensor,
                         weights: torch.Tensor) -> Dict[str, Any]:
        """The joint divergence (mmvae.py:250-260): against the alpha-PoE
        dynamic prior under ``jsd``, against N(0, I) otherwise; normalised
        by the configured batch size."""
        cfg = self.cfg
        if cfg.method_enum.uses_dynamic_prior:
            div, klds, dyn_prior = KL.alpha_jsd_divergence(
                mus, logvars, weights, normalization=cfg.batch_size)
            return {"joint_divergence": div, "individual_divs": klds, "dyn_prior": dyn_prior}
        div, klds = KL.group_divergence_moe(mus, logvars, weights, normalization=cfg.batch_size)
        return {"joint_divergence": div, "individual_divs": klds, "dyn_prior": None}

    def forward(
        self,
        batch: Mapping[str, torch.Tensor],
        text_prehead: bool = False,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Union[torch.Tensor, float]] = None,
    ) -> Dict[str, Any]:
        """The training forward (mmvae.py:266-304): posteriors, the joint
        divergence, z from the joint (noise from ``generator`` or the
        injected ``eps``) and the reconstruction of each modality in
        ``batch``. ``text_prehead=True`` makes the text decoder return its
        pre-head features [B, L, C] for the fused head."""
        latents = self.inference(batch)
        div = self.joint_divergence(latents["mus"], latents["logvars"], latents["weights"])
        joint_mu, joint_lv = latents["joint"]
        z = reparameterize(joint_mu, joint_lv, generator=generator, eps=eps)
        rec: Dict[str, torch.Tensor] = {}
        for m in self.cfg.modality_names:
            if m not in batch:
                continue
            if m == "text" and text_prehead:
                rec[m] = self.decoder(m)(z, prehead=True)
            else:
                rec[m] = self.decoder(m)(z)
        return {"latents": latents, "group_distr": latents["joint"], "rec": rec, **div}

    # ------------------------------------------------------------------

    def generate(self, num_samples: int,
                 generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Decode ``num_samples`` draws from the N(0, I) prior; ``generator``
        lives on the model's device."""
        device = next(self.parameters()).device
        z = torch.randn((num_samples, self.cfg.class_dim), generator=generator, device=device)
        return self.generate_from_latents(z)

    def generate_from_latents(self, z: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every modality's likelihood mean for content latent ``z``: images
        as decoded, text as softmax probabilities (exp of log-softmax)."""
        out: Dict[str, torch.Tensor] = {}
        for m in self.cfg.modality_names:
            y = self.decoder(m)(z)
            out[m] = torch.exp(y) if m == "text" else y
        return out

    def cond_generation(
        self,
        latent_distributions: Mapping[str, Posterior],
        generator: Optional[torch.Generator] = None,
        eps: Optional[Union[torch.Tensor, float]] = None,
    ) -> Dict[str, Dict[str, torch.Tensor]]:
        """Generate from each subset posterior: z = mu + eps·std, with eps
        drawn from ``generator`` per subset in order, or the injected
        ``eps`` (``eps=0`` decodes the posterior means)."""
        out: Dict[str, Dict[str, torch.Tensor]] = {}
        for key, (mu, lv) in latent_distributions.items():
            z = reparameterize(mu, lv, generator=generator, eps=eps)
            out[key] = self.generate_from_latents(z)
        return out

