"""The fused word-text vocab head: features → target log-probability.

Port of ``mopoe_mimic_tpu/ops/pallas_texthead.py``. The train step's text
log-likelihood only needs the target token's log-probability, so the
head's [B, L, vocab] logits need never be kept: the forward saves only the
per-row logsumexp and the backward recomputes the logits.

``fused_text_logprob`` dispatches on the device of its tensors: on CUDA to
the hand-written kernels (``ops/cuda_texthead.py``, ``csrc/texthead.cu``),
which launch or raise; on the CPU to the plain pair here, which mirrors the
Pallas kernels ``_fwd_kernel`` (:72) and ``_bwd_kernel`` (:88) and is the
kernels' oracle:

  * forward:  logits = h@W + b, accumulated in float32 from inputs in the
    compute dtype; lse = logsumexp(logits); lp = logits[target] − lse;
  * backward: dlog = (onehot − softmax)·g, rounded to h's dtype (:101);
    dh = dlog@Wᵀ (in h's dtype), dW = hᵀ@dlog, db = Σ dlog (float32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from mopoe_mimic_tpu_torch.ops.cuda_texthead import texthead_cuda


class TextHeadInputs(NamedTuple):
    """What the train step puts in place of the text reconstruction when
    the fused head is on: pre-head features [B, L, C] and the vocab head's
    kernel [C, V] and bias [V]. ``train/losses.modality_log_prob`` runs
    the fused head on it."""

    h: torch.Tensor
    kernel: torch.Tensor
    bias: torch.Tensor


def reference_text_logprob(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                           targets: torch.Tensor) -> torch.Tensor:
    """Unfused float32 reference (pallas_texthead.py:243): h [..., C] @
    kernel [C, V] + bias → log_softmax → the target's entry."""
    logits = h.float() @ kernel.float() + bias.float()
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, targets.long().unsqueeze(-1)).squeeze(-1)


def _acc(h: torch.Tensor, acc_dtype: Optional[torch.dtype]) -> torch.dtype:
    """float32 accumulation as the kernels, or float64 for float64 inputs
    or when asked (an oracle for long sums)."""
    return acc_dtype or torch.promote_types(h.dtype, torch.float32)


def texthead_fwd_plain(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       targets: torch.Tensor, acc_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [R, C], kernel [C, V] (one dtype), bias [V], targets [R] →
    (lp, lse) [R], accumulated in ``acc_dtype`` (default: ``_acc``)."""
    acc_dtype = _acc(h, acc_dtype)
    logits = h.to(acc_dtype) @ kernel.to(acc_dtype) + bias.to(acc_dtype)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, 1, targets.long().unsqueeze(1)).squeeze(1)
    return tgt - lse, lse


def texthead_dlog_plain(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                        targets: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                        acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """dlog = (onehot − exp(logits − lse))·g [R, V], rounded to h's dtype
    and held in ``acc_dtype``: the logits recomputed from the saved lse."""
    acc_dtype = _acc(h, acc_dtype)
    logits = h.to(acc_dtype) @ kernel.to(acc_dtype) + bias.to(acc_dtype)
    onehot_minus_p = -torch.exp(logits - lse.to(acc_dtype).unsqueeze(1))
    rows = torch.arange(h.shape[0], device=h.device)
    onehot_minus_p[rows, targets.long()] += 1.0
    return (onehot_minus_p * g.to(acc_dtype).unsqueeze(1)).to(h.dtype).to(acc_dtype)


def texthead_bwd_plain(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       targets: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                       acc_dtype: Optional[torch.dtype] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """From the saved lse and the upstream gradient g [R] → dh [R, C] in
    h's dtype, dW [C, V] and db [V] in ``acc_dtype``."""
    acc_dtype = _acc(h, acc_dtype)
    dlog = texthead_dlog_plain(h, kernel, bias, targets, lse, g, acc_dtype)
    dh = (dlog @ kernel.to(acc_dtype).t()).to(h.dtype)
    dw = h.to(acc_dtype).t() @ dlog
    db = dlog.sum(dim=0)
    return dh, dw, db


class _PlainTextHead(torch.autograd.Function):
    """The plain explicit forward/backward pair; saves only lse."""

    @staticmethod
    def forward(ctx, h, kernel, bias, targets):
        with torch.autocast(h.device.type, enabled=False):
            lp, lse = texthead_fwd_plain(h, kernel, bias, targets)
        ctx.save_for_backward(h, kernel, bias, targets, lse)
        return lp

    @staticmethod
    def backward(ctx, g):
        h, kernel, bias, targets, lse = ctx.saved_tensors
        with torch.autocast(h.device.type, enabled=False):
            dh, dw, db = texthead_bwd_plain(h, kernel, bias, targets, lse, g)
        return dh, dw.to(kernel.dtype), db.to(bias.dtype), None


def fused_text_logprob(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Per-position target log-probability of the word-text vocab head,
    ``log_softmax(h @ kernel + bias)[..., target]``.

    h [B, L, C]; kernel [C, V] (or the flax-shaped [1, C, V]); bias [V];
    targets [B, L] (or [B, L, 1]) token ids. The kernel is cast to h's
    dtype, the compute dtype, as the JAX function casts it
    (pallas_texthead.py:232). Returns [B, L] float32 (float64 for float64
    inputs).
    """
    if kernel.dim() == 3:
        kernel = kernel[0]
    if targets.dim() == 3:
        targets = targets.squeeze(-1)
    B, L, C = h.shape
    h2 = h.reshape(B * L, C).contiguous()
    k2 = kernel.to(h.dtype).contiguous()
    t2 = targets.reshape(B * L)
    tensors = (h, kernel, bias, targets)
    if all(x.is_cuda for x in tensors):
        lp = texthead_cuda(h2, k2, bias, t2)
    elif not any(x.is_cuda for x in tensors):
        lp = _PlainTextHead.apply(h2, k2, bias, t2)
    else:
        raise ValueError("fused_text_logprob: inputs lie on different devices")
    return lp.reshape(B, L)
