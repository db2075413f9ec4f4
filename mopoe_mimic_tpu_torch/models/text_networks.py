"""Report text: the char and word encoders and decoders, NCL inside.

Port of ``mopoe_mimic_tpu/models/text_networks.py`` (reference
char_encoding/FeatureExtractorText.py, char_encoding/DataGeneratorText.py,
word_encoding/mmvae_text_enc.py, word_encoding/DataGeneratorText.py).
1-D blocks keep their conv bias; the stem ``conv1`` has one.

  * char (``len_sequence`` 1024): a one-hot [B, 1024, 71] (the JAX layout,
    transposed to NCL here) → ``conv1`` 71→d (4, 2, 1) → 7 blocks of widths
    [2d, 3d, 4d, 4d, 4d, 5d, 5d] at (4, 2, 1) → ``resblock_8`` 5d at
    (4, 2, 0), down to length 1 (text_networks.py:39-66). The decoder:
    ``resblock_1`` 5d at (4, 1, 0), 7 transpose blocks of widths
    [5d, 5d, 4d, 4d, 3d, 2d, d], then ``conv2``, a ``ConvTranspose1d`` to the
    71 classes at (4, 2, 1), and a log-softmax over the classes in float32
    (:69-100). Keys ``feature_extractor.{conv1,resblock_K.0}`` and
    ``text_generator.{resblock_K.0,conv2}``.
  * word: ids [B, L] → embedding → ``conv1`` → 6 blocks, 8 when
    ``len_sequence`` > 500 (:140-142). The decoder is a ``Sequential``
    (``text_generator.generator.N``): at length 128, 6 blocks and a plain
    ``Conv1d(k1)`` to the vocabulary (``prehead=True`` stops before it,
    :162-211); at length ≥ 512, 8 blocks (the last three at [3d, 2d, d]) and
    a ``ConvTranspose1d`` to the vocabulary at (4, 2, 1) (:183-190).

Other lengths raise, as the JAX package does (:201-204). ``fused_pointwise``
and ``bn_dtype`` go to every residual block (text_networks.py:44-312 of the
JAX package).
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

LEN_WORD, LEN_CHAR = 128, 1024


def _check_len(text_encoding: str, len_sequence: int) -> None:
    if text_encoding == "char":
        ok = len_sequence == LEN_CHAR
    elif text_encoding == "word":
        ok = len_sequence == LEN_WORD or len_sequence >= 512
    else:
        raise NotImplementedError(f"text_encoding {text_encoding!r}")
    if not ok:
        raise NotImplementedError(
            f"len_sequence {len_sequence} unsupported for {text_encoding} text "
            f"(char: {LEN_CHAR}; word: {LEN_WORD} or >= 512)")


class FeatureExtractorTextChar(nn.Module):
    """One-hot [B, 1024, 71] → [B, 5·dim]."""

    def __init__(self, dim: int, num_features: int, bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = dim
        self.conv1 = nn.Conv1d(num_features, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d, 5 * d]
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        for i in range(1, 8):
            setattr(self, f"resblock_{i}",
                    block(ResidualBlock1dConv(widths[i - 1], widths[i], 4, 2, 1, **kw)))
        self.resblock_8 = block(ResidualBlock1dConv(5 * d, 5 * d, 4, 2, 0, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x.transpose(1, 2))  # [B, L, A] → [B, A, L] → [B, d, L/2]
        for i in range(1, 9):
            h = getattr(self, f"resblock_{i}")(h)
        return h.reshape(h.shape[0], -1)


class DataGeneratorTextChar(nn.Module):
    """[B, 5·dim, 1] → log-probabilities [B, 1024, 71] (float32)."""

    def __init__(self, dim: int, num_features: int, bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d = dim
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        self.resblock_1 = block(ResidualBlock1dTransposeConv(5 * d, 5 * d, 4, 1, 0, **kw))
        widths = [5 * d, 5 * d, 5 * d, 4 * d, 4 * d, 3 * d, 2 * d, d]
        for i in range(2, 9):
            setattr(self, f"resblock_{i}", block(
                ResidualBlock1dTransposeConv(widths[i - 2], widths[i - 1], 4, 2, 1, **kw)))
        self.conv2 = nn.ConvTranspose1d(d, num_features, 4, 2, 1, bias=True)

    def forward(self, feats: torch.Tensor, prehead: bool = False) -> torch.Tensor:
        if prehead:
            raise NotImplementedError("prehead needs word text at len_sequence 128")
        h = feats
        for i in range(1, 9):
            h = getattr(self, f"resblock_{i}")(h)
        return torch.log_softmax(at_least_f32(self.conv2(h).transpose(1, 2)), dim=-1)


class FeatureExtractorTextWord(nn.Module):
    """Token ids [B, L] → [B, 5·dim]."""

    def __init__(self, dim: int, vocab_size: int, len_sequence: int = LEN_WORD,
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_len("word", len_sequence)
        d = dim
        self.embedding = nn.Embedding(vocab_size, d)
        self.conv1 = nn.Conv1d(d, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d]
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        for i in range(1, 7):
            setattr(self, f"resblock_{i}",
                    block(ResidualBlock1dConv(widths[i - 1], widths[i], 4, 2, 1, **kw)))
        # resblock_7/8 run only beyond length 500 (text_networks.py:140-142);
        # at 128 the reference builds them but never runs them, so not built
        self.n_blocks = 8 if len_sequence > 500 else 6
        if self.n_blocks == 8:
            self.resblock_7 = block(ResidualBlock1dConv(5 * d, 5 * d, 4, 2, 1, **kw))
            self.resblock_8 = block(ResidualBlock1dConv(5 * d, 5 * d, 4, 2, 0, **kw))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        ids = ids.long()
        # index 0 (<exc>) maps to zero by masking, not padding_idx, so that a
        # converted JAX embedding with a non-zero row 0 behaves the same
        emb = self.embedding(ids) * (ids != 0).unsqueeze(-1).to(self.embedding.weight.dtype)
        h = self.conv1(emb.transpose(1, 2))  # [B, D, L]
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"resblock_{i}")(h)
        return h.reshape(h.shape[0], -1)


class DataGeneratorTextWord(nn.Module):
    """[B, 5·dim, 1] → log-probabilities [B, L, vocab]."""

    def __init__(self, dim: int, vocab_size: int, len_sequence: int = LEN_WORD,
                 last_layer: str = "softmax", bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None):
        super().__init__()
        _check_len("word", len_sequence)
        if last_layer not in ("softmax", "sigmoid", "none"):
            raise NotImplementedError(last_layer)
        self.last_layer = last_layer
        self.short = len_sequence == LEN_WORD
        d = dim
        if self.short:
            widths = [5 * d, 5 * d, 5 * d, 5 * d, 4 * d, 4 * d, d]
        else:
            widths = [5 * d, 5 * d, 5 * d, 5 * d, 4 * d, 4 * d, 3 * d, 2 * d, d]
        geometry = [(4, 1, 0)] + [(4, 2, 1)] * (len(widths) - 2)
        kw = dict(bn_eps=bn_eps, fused_pointwise=fused_pointwise, bn_dtype=bn_dtype)
        layers = [block(ResidualBlock1dTransposeConv(widths[i], widths[i + 1], *geometry[i], **kw))
                  for i in range(len(widths) - 1)]
        if self.short:
            layers.append(nn.Conv1d(d, vocab_size, 1, 1, 0, bias=True))
        else:
            layers.append(nn.ConvTranspose1d(d, vocab_size, 4, 2, 1, bias=True))
        self.generator = nn.Sequential(*layers)

    def forward(self, feats: torch.Tensor, prehead: bool = False) -> torch.Tensor:
        """``prehead=True`` (length 128) returns the features before the
        vocab head ``generator[6]`` as [B, L, C], for the fused head + log-prob
        (``ops/texthead.py``); the parameters are the same in both modes."""
        if prehead:
            if not self.short:
                raise NotImplementedError("prehead needs word text at len_sequence 128")
            return self.generator[:-1](feats).transpose(1, 2)  # [B, C, L] → [B, L, C]
        h = self.generator(feats).transpose(1, 2)  # [B, V, L] → [B, L, V]
        if self.last_layer == "softmax":
            return torch.log_softmax(at_least_f32(h), dim=-1)
        if self.last_layer == "sigmoid":
            return torch.sigmoid(h)
        return h


class EncoderText(nn.Module):
    """Char one-hots or word ids → (mu, logvar) of the content latent."""

    def __init__(self, dim: int, class_dim: int, num_features: int,
                 len_sequence: int = LEN_WORD, bn_eps: float = 1e-5,
                 fused_pointwise: bool = False, bn_dtype: Optional[torch.dtype] = None,
                 text_encoding: str = "word"):
        super().__init__()
        _check_len(text_encoding, len_sequence)
        if text_encoding == "char":
            self.feature_extractor = FeatureExtractorTextChar(dim, num_features, bn_eps,
                                                              fused_pointwise, bn_dtype)
        else:
            self.feature_extractor = FeatureExtractorTextWord(dim, num_features, len_sequence,
                                                              bn_eps, fused_pointwise, bn_dtype)
        self.feature_compressor = LinearFeatureCompressor(5 * dim, class_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.feature_compressor(self.feature_extractor(x))


class DecoderText(nn.Module):
    """Content latent → per-position log-probabilities [B, L, classes]."""

    def __init__(self, dim: int, class_dim: int, num_features: int,
                 len_sequence: int = LEN_WORD, last_layer: str = "softmax",
                 bn_eps: float = 1e-5, fused_pointwise: bool = False,
                 bn_dtype: Optional[torch.dtype] = None, text_encoding: str = "word"):
        super().__init__()
        _check_len(text_encoding, len_sequence)
        self.feature_generator = nn.Linear(class_dim, 5 * dim)
        if text_encoding == "char":
            self.text_generator = DataGeneratorTextChar(dim, num_features, bn_eps,
                                                        fused_pointwise, bn_dtype)
        else:
            self.text_generator = DataGeneratorTextWord(dim, num_features, len_sequence,
                                                        last_layer, bn_eps, fused_pointwise,
                                                        bn_dtype)

    def forward(self, z: torch.Tensor, prehead: bool = False) -> torch.Tensor:
        feats = self.feature_generator(z)
        return self.text_generator(feats.reshape(feats.shape[0], -1, 1), prehead=prehead)
