"""CheXpert-label classifiers for the coherence evaluation
(``mopoe_mimic_tpu/models/classifiers.py``).

Parity:
  * ClfImg (mimic/networks/ConvNetworkImgClf.py:12-88): a 3×3 stride-2
    conv to 128 channels, then the residual trunk at fixed widths
    128 → 256 → 384 → 512 → 640 (+ the tail of the image size), a linear
    head and a sigmoid multi-label output;
  * ClfText (mimic/networks/ConvNetworkTextClf.py:6-88): char one-hots or
    word ids (an embedding, id 0 masked to zero), a stride-2 conv, residual
    blocks 1-6 (blocks 7 and 8 only for ``len_sequence > 500``), dropout
    0.5, linear and sigmoid.

The blocks are the port's ``models/resblocks.py`` (a = 2.0, b = 0.3,
dropout 0.5: channel-wise (``Dropout2d``) in the 2-D image blocks, which
have no conv bias, element-wise in the 1-D text blocks, which do), in
float32 with float32 BatchNorm whatever the VAE's compute dtype, as the JAX
classifiers are built. Layouts: images NCHW; text word ids [B, L] or a
char one-hot [B, L, 71] (the JAX layout). The features are flattened in
the JAX package's channels-last order, so that its dense kernel maps onto
``linear`` by a transpose. The DenseNet/CheXNet classifier is not ported
(``img_clf_type="densenet"`` raises in ``train/clf_trainer.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from mopoe_mimic_tpu_torch.models.resblocks import ResidualBlock1dConv, ResidualBlock2dConv, block

# the trunk's blocks after the 3×3 conv: (out channels, padding), by image size
_IMG_BLOCKS = {
    64: [(256, 1), (384, 1), (512, 1), (640, 0)],
    128: [(256, 1), (384, 1), (512, 1), (640, 1), (640, 0)],
    256: [(256, 1), (384, 1), (512, 1), (576, 1), (640, 1), (640, 0)],
}


def _conv_len(n: int, padding: int) -> int:
    """Length after a kernel-4, stride-2 convolution with ``padding``."""
    return (n + 2 * padding - 4) // 2 + 1


class ClfImg(nn.Module):
    """[B, C, H, W] → sigmoid probabilities [B, n_labels]."""

    def __init__(self, n_labels: int, img_size: int = 128, image_channels: int = 1):
        super().__init__()
        if img_size not in _IMG_BLOCKS:
            raise NotImplementedError(f"img_size {img_size}")
        self.conv1 = nn.Conv2d(image_channels, 128, 3, 2, 1, bias=False)
        width = 128
        for i, (out, pad) in enumerate(_IMG_BLOCKS[img_size], start=1):
            setattr(self, f"resblock_{i}", block(ResidualBlock2dConv(width, out, 4, 2, pad)))
            width = out
        self.n_blocks = len(_IMG_BLOCKS[img_size])
        self.linear = nn.Linear(width, n_labels)  # the trunk ends at 1×1

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x)
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"resblock_{i}")(h)
        feats = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        return torch.sigmoid(self.linear(feats))


class ClfText(nn.Module):
    """Word ids [B, L] or a char one-hot [B, L, num_features] → sigmoid
    probabilities [B, n_labels]."""

    def __init__(self, n_labels: int, dim: int = 128, text_encoding: str = "char",
                 num_features: int = 71, vocab_size: int = 0, len_sequence: int = 1024):
        super().__init__()
        d = dim
        self.word = text_encoding == "word"
        if self.word:
            self.embedding = nn.Embedding(vocab_size, d)
        self.conv1 = nn.Conv1d(d if self.word else num_features, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d]
        blocks = [(widths[i], widths[i + 1], 1) for i in range(6)]
        if len_sequence > 500:
            blocks += [(5 * d, 5 * d, 1), (5 * d, 5 * d, 0)]
        length = _conv_len(len_sequence, 1)
        for i, (c_in, c_out, pad) in enumerate(blocks, start=1):
            setattr(self, f"resblock_{i}", block(ResidualBlock1dConv(c_in, c_out, 4, 2, pad)))
            length = _conv_len(length, pad)
        self.n_blocks = len(blocks)
        self.dropout = nn.Dropout(0.5)
        self.linear = nn.Linear(5 * d * length, n_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.word:
            ids = x.long()
            h = self.embedding(ids) * (ids != 0).unsqueeze(-1).to(self.embedding.weight.dtype)
        else:
            h = x
        h = self.conv1(h.transpose(1, 2))  # [B, L, C] → [B, C, L]
        for i in range(1, self.n_blocks + 1):
            h = getattr(self, f"resblock_{i}")(h)
        h = self.dropout(h)
        feats = h.transpose(1, 2).reshape(h.shape[0], -1)
        return torch.sigmoid(self.linear(feats))
