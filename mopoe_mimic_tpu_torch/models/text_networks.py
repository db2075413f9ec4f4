"""Word-encoded report text: encoder and decoder at len_sequence 128, NCL.

Port of the word path of ``mopoe_mimic_tpu/models/text_networks.py``
(reference word_encoding/mmvae_text_enc.py, word_encoding/DataGeneratorText.py).
1-D blocks keep their conv bias; the stem ``conv1`` has one. The decoder
ends in a plain ``Conv1d(k1)`` to the vocabulary, not a transposed conv;
``prehead=True`` stops before it (text_networks.py:162-211 of the JAX
package).
``fused_pointwise`` and ``bn_dtype`` go to every residual block
(text_networks.py:44-312 of the JAX package). The char-1024 path is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mopoe_mimic_tpu_torch.models.compressor import LinearFeatureCompressor
from mopoe_mimic_tpu_torch.models.resblocks import (
    ResidualBlock1dConv,
    ResidualBlock1dTransposeConv,
    at_least_f32,
    block,
)

LEN_SEQUENCE = 128


def _check_len(len_sequence: int) -> None:
    if len_sequence != LEN_SEQUENCE:
        raise NotImplementedError(
            f"len_sequence {len_sequence}: only word encoding at {LEN_SEQUENCE} is ported")


class FeatureExtractorTextWord(nn.Module):
    """Token ids [B, L] → [B, 5·dim]."""

    def __init__(self, dim: int, vocab_size: int, len_sequence: int = LEN_SEQUENCE,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_len(len_sequence)
        d = dim
        self.embedding = nn.Embedding(vocab_size, d)
        self.conv1 = nn.Conv1d(d, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d]
        # resblock_7/8 exist in the reference only beyond len 500, and are
        # never run at len 128 (text_networks.py:140-142), so not built
        for i in range(1, 7):
            setattr(self, f"resblock_{i}", block(
                ResidualBlock1dConv(widths[i - 1], widths[i], 4, 2, 1, bn_eps=bn_eps,
                                    fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        # index 0 (<exc>) maps to zero by masking, not padding_idx, so that a
        # converted JAX embedding with a non-zero row 0 behaves the same
        emb = self.embedding(ids) * (ids != 0).unsqueeze(-1).to(self.embedding.weight.dtype)
        h = self.conv1(emb.transpose(1, 2))  # [B, D, L]
        for i in range(1, 7):
            h = getattr(self, f"resblock_{i}")(h)
        return h.reshape(h.shape[0], -1)


class DataGeneratorTextWord(nn.Module):
    """[B, 5·dim, 1] → log-probabilities [B, L, vocab]."""

    def __init__(self, dim: int, vocab_size: int, len_sequence: int = LEN_SEQUENCE,
                 last_layer: str = "softmax", bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_len(len_sequence)
        if last_layer not in ("softmax", "sigmoid", "none"):
            raise NotImplementedError(last_layer)
        self.last_layer = last_layer
        d = dim
        widths = [5 * d, 5 * d, 5 * d, 5 * d, 4 * d, 4 * d, 1 * d]
        geometry = [(4, 1, 0)] + [(4, 2, 1)] * 5
        layers = [
            block(ResidualBlock1dTransposeConv(widths[i], widths[i + 1], *geometry[i],
                                               bn_eps=bn_eps, fused_pointwise=fused_pointwise,
                                               bn_dtype=bn_dtype))
            for i in range(6)
        ]
        layers.append(nn.Conv1d(d, vocab_size, 1, 1, 0, bias=True))
        self.generator = nn.Sequential(*layers)

    def forward(self, feats: torch.Tensor, prehead: bool = False) -> torch.Tensor:
        """``prehead=True`` returns the features before the vocab head
        ``generator[6]`` as [B, L, C], for the fused head + log-prob
        (``ops/texthead.py``); the parameters are the same in both modes."""
        if prehead:
            return self.generator[:-1](feats).transpose(1, 2)  # [B, C, L] → [B, L, C]
        h = self.generator(feats).transpose(1, 2)  # [B, V, L] → [B, L, V]
        if self.last_layer == "softmax":
            return torch.log_softmax(at_least_f32(h), dim=-1)
        if self.last_layer == "sigmoid":
            return torch.sigmoid(h)
        return h


class EncoderText(nn.Module):
    """Token ids → (mu, logvar) of the content latent."""

    def __init__(self, dim: int, class_dim: int, vocab_size: int,
                 len_sequence: int = LEN_SEQUENCE, bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_extractor = FeatureExtractorTextWord(dim, vocab_size, len_sequence, bn_eps,
                                                          fused_pointwise, bn_dtype)
        self.feature_compressor = LinearFeatureCompressor(5 * dim, class_dim)

    def forward(self, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.feature_compressor(self.feature_extractor(ids))


class DecoderText(nn.Module):
    """Content latent → per-position log-probabilities [B, L, vocab]."""

    def __init__(self, dim: int, class_dim: int, vocab_size: int,
                 len_sequence: int = LEN_SEQUENCE, last_layer: str = "softmax",
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_generator = nn.Linear(class_dim, 5 * dim)
        self.text_generator = DataGeneratorTextWord(dim, vocab_size, len_sequence,
                                                    last_layer, bn_eps, fused_pointwise, bn_dtype)

    def forward(self, z: torch.Tensor, prehead: bool = False) -> torch.Tensor:
        feats = self.feature_generator(z)
        return self.text_generator(feats.reshape(feats.shape[0], -1, 1), prehead=prehead)
