"""The train and eval steps.

Port of ``mopoe_mimic_tpu/train/step.py``: forward, objective, gradients,
clipping and the Adam update. The state is updated in place and the step
returns its metrics as tensors on the device, so the host never waits for
the card inside a step. The step bodies (``make_train_step_body``,
``make_eval_step_body``) take a batch on the device and do no per-step
work on the host, so that ``train/scan.py`` can capture them in a CUDA
graph; ``make_train_step`` and ``make_eval_step`` run them eagerly on a
batch from anywhere.

Method dispatch as in the JAX package: moe, jsd and joint_elbo take
``calc_joint_elbo_loss``; poe adds a unimodal ELBO per modality, each a
full forward that advances the BatchNorm running statistics in call order
(joint, then each modality of the batch).

``cfg.fused_text_head`` sends the text log-likelihood through the fused
vocab head (``ops/texthead.py``: the CUDA kernels K2 on the card, the
plain pair on the CPU) for word text at length 128 with a softmax last
layer. ``cfg.fused_pointwise`` runs every residual block's opening
BN → ReLU → 1×1 conv as one fused op in train mode (``ops/pointwise.py``:
the CUDA kernels K3 on the card, the plain versions on the CPU), built
into the model (``models/mmvae.py``); the eval step runs the modules.
``compute_dtype="bfloat16"`` runs the step under
``torch.autocast(bfloat16)``; BatchNorm runs in ``cfg.bn_compute_dtype``
(float32 by default, bfloat16 under ``"compute"``: ``models/resblocks.py``),
the fused head's inputs and K3's products take bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch

from mopoe_mimic_tpu_torch.config import Method
from mopoe_mimic_tpu_torch.ops.texthead import TextHeadInputs
from mopoe_mimic_tpu_torch.train.losses import (
    calc_elbo,
    calc_joint_elbo_loss,
    calc_klds,
    calc_log_probs,
    modality_log_prob,
)
from mopoe_mimic_tpu_torch.train.state import TrainState, set_step_learning_rate

Eps = Optional[Union[torch.Tensor, float]]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def compute_dtype(cfg) -> torch.dtype:
    """bfloat16 (under autocast), float32, or float64 (a float64 model:
    the oracle runs of chip_smoke.py)."""
    if cfg.compute_dtype not in _DTYPES:
        raise NotImplementedError(f"compute_dtype {cfg.compute_dtype!r}")
    return _DTYPES[cfg.compute_dtype]


def _autocast(cfg, device: torch.device):
    """bfloat16 autocast without its cache of weight casts, as PyTorch
    requires where a CUDA graph captures the step (``train/scan.py``): the
    cache would free its casts at the context's exit while the graph still
    reads them."""
    if compute_dtype(cfg) == torch.bfloat16:
        return torch.autocast(device.type, dtype=torch.bfloat16, cache_enabled=False)
    return contextlib.nullcontext()


@contextlib.contextmanager
def eval_mode(cfg, model: torch.nn.Module):
    """``model`` in eval mode (BN running statistics, no dropout), without
    gradients, under the compute dtype's autocast; its mode restored
    after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), _autocast(cfg, next(model.parameters()).device):
            yield
    finally:
        model.train(was_training)


def _use_fused_text_head(cfg, batch: Mapping[str, Any]) -> bool:
    """The fused head applies to the word/128/softmax head only, and only
    when text is in the batch (step.py:45-55)."""
    return (cfg.fused_text_head and "text" in batch and cfg.text_encoding == "word"
            and cfg.len_sequence == 128 and cfg.text_gen_lastlayer == "softmax")


def _wrap_text_head(cfg, outs: Dict[str, Any], model) -> Dict[str, Any]:
    """Put the pre-head features, cast to the compute dtype, and the vocab
    head's kernel [C, V] and bias in place of the text reconstruction;
    gradients reach the head's parameters through them."""
    head = model.decoder("text").text_generator.generator[-1]
    outs["rec"]["text"] = TextHeadInputs(
        outs["rec"]["text"].to(compute_dtype(cfg)), head.weight[:, :, 0].t(), head.bias)
    return outs


def to_device(batch: Mapping[str, Any], param: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Tensors on the parameters' device; uint8 modalities dequantised by
    1/255, floating ones in the parameters' dtype."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v).to(param.device, non_blocking=True)
        if v.dtype == torch.uint8:
            v = v.to(param.dtype) / 255.0
        out[k] = v.to(param.dtype) if v.is_floating_point() else v
    return out


def _forward_and_objective(cfg, model, batch: Mapping[str, torch.Tensor],
                           generator: Optional[torch.Generator] = None, eps: Eps = None):
    """Forward, total loss and metrics (step.py:72-169). ``eps`` injects the
    reparameterisation noise (``eps=0`` decodes the joint's means)."""
    fused_text = _use_fused_text_head(cfg, batch)
    outs = model(batch, text_prehead=fused_text, generator=generator, eps=eps)
    if fused_text:
        outs = _wrap_text_head(cfg, outs, model)

    log_probs, weighted_lp = calc_log_probs(cfg, outs["rec"], batch)
    klds = calc_klds(cfg, outs["latents"]["subsets"])
    group_div = outs["joint_divergence"]

    if cfg.method_enum is Method.POE:
        # one unimodal forward per modality, in batch order, each advancing
        # the BN running statistics (step.py:113-139)
        elbos = {}
        for m in batch:
            fused_m = fused_text and m == "text"
            outs_m = model({m: batch[m]}, text_prehead=fused_m, generator=generator, eps=eps)
            if fused_m:
                outs_m = _wrap_text_head(cfg, outs_m, model)
            rec_m = -modality_log_prob(cfg, m, outs_m["rec"][m], batch[m])
            elbos[m] = calc_elbo(cfg, m, {m: rec_m}, klds[m])
        elbos["joint"] = calc_elbo(cfg, "joint", log_probs, group_div)
        total_loss = sum(elbos.values())
    else:
        total_loss = calc_joint_elbo_loss(cfg, weighted_lp, group_div)

    posteriors = outs["latents"]["modalities"]
    nan_in_latents = torch.stack([torch.isnan(t).any() for mu_lv in posteriors.values()
                                  for t in mu_lv]).any()
    metrics = {
        "total_loss": total_loss,
        "joint_divergence": group_div,
        "klds": klds,
        "log_probs": log_probs,
        "weighted_log_prob": weighted_lp,
        "latents": {m: (mu.mean(), lv.mean()) for m, (mu, lv) in posteriors.items()},
        "nan_in_latents": nan_in_latents,
    }
    return total_loss, metrics


def loss_terms(metrics: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Every scalar loss term of a step's metrics, by name: the total, the
    joint divergence, the weighted log-probability, ``kld/<subset>`` and
    ``log_prob/<modality>``."""
    terms = {k: metrics[k] for k in ("total_loss", "joint_divergence", "weighted_log_prob")}
    terms.update({f"kld/{k}": v for k, v in metrics["klds"].items()})
    terms.update({f"log_prob/{k}": v for k, v in metrics["log_probs"].items()})
    return terms


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_detach(v) for v in tree)
    return tree.detach()


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ x²) over every tensor, as ``optax.global_norm``: one norm per
    tensor (``torch._foreach_norm``), then the norm of those."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


def static_grads(params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """Each parameter's gradient, made (zeros) where it has none. The step
    zeroes and fills these tensors in place, so they keep their storage
    from step to step (a CUDA graph replays into them) and every parameter
    has one, zero where the loss does not reach it (optax updates every
    leaf)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return [p.grad for p in params]


def make_train_step_body(cfg, eps: Eps = None) -> Callable[[TrainState, Mapping[str, torch.Tensor]],
                                                           Dict]:
    """``body(state, batch) -> metrics``: one Adam step in place on a batch
    already on the parameters' device, in the port's layouts, with nothing
    that waits for the host or works on it per step: the gradients are
    zeroed on the device, the learning rate is written there from the
    device step count ``state.step_t`` (``set_step_learning_rate``), and the
    metrics stay tensors. ``make_train_step`` runs it eagerly;
    ``train/scan.make_train_epoch`` captures it in a CUDA graph. The host's
    step count ``state.step`` is the caller's. ``metrics["grad_norm"]`` is
    the global norm before clipping (step.py:207); ``eps`` injects the
    reparameterisation noise for tests, by default drawn from
    ``state.generator``."""
    clip = float(cfg.grad_clip_norm)

    def body(state: TrainState, batch: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        model, opt = state.model, state.optimizer
        device = state.step_t.device
        model.train()
        grads = static_grads([p for group in opt.param_groups for p in group["params"]])
        torch._foreach_zero_(grads)
        with _autocast(cfg, device):
            total, metrics = _forward_and_objective(cfg, model, batch, state.generator, eps)
        total.backward()
        grad_norm = global_norm(grads)
        if clip > 0:  # optax.clip_by_global_norm
            scale = torch.where(grad_norm < clip, torch.ones_like(grad_norm), clip / grad_norm)
            torch._foreach_mul_(grads, scale)
        set_step_learning_rate(cfg, state)
        opt.step()
        state.step_t += 1
        metrics = _detach(metrics)
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return body


def make_train_step(cfg, eps: Eps = None) -> Callable[[TrainState, Mapping[str, Any]], Dict]:
    """``train_step(state, batch) -> metrics``: one Adam step in place
    (``make_train_step_body``), eagerly, for one batch from anywhere.

    ``batch`` holds the port's layouts (images NCHW, text ids [B, L]) as
    tensors or numpy arrays; uint8 images are dequantised."""
    body = make_train_step_body(cfg, eps)

    def train_step(state: TrainState, batch: Mapping[str, Any]) -> Dict[str, Any]:
        metrics = body(state, to_device(batch, next(state.model.parameters())))
        state.step += 1
        return metrics

    return train_step


def make_eval_step_body(cfg, eps: Eps = None) -> Callable[..., Dict]:
    """``body(state, batch, generator) -> metrics``: the forward in eval
    mode (BN running statistics, no dropout) and the objective, without
    gradients, on a batch on the parameters' device; noise from
    ``generator``. The model's mode is restored after."""

    def body(state: TrainState, batch: Mapping[str, torch.Tensor],
             generator: torch.Generator) -> Dict[str, Any]:
        with eval_mode(cfg, state.model):
            _, metrics = _forward_and_objective(cfg, state.model, batch, generator, eps)
        return metrics

    return body


def make_eval_step(cfg, eps: Eps = None) -> Callable[..., Dict]:
    """``eval_step(state, batch, generator=None) -> metrics``
    (``make_eval_step_body``) for one batch from anywhere; noise from
    ``generator`` or ``state.generator``."""
    body = make_eval_step_body(cfg, eps)

    def eval_step(state: TrainState, batch: Mapping[str, Any],
                  generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        return body(state, to_device(batch, next(state.model.parameters())),
                    generator or state.generator)

    return eval_step
