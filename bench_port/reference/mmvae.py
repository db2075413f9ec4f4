"""Plain PyTorch reference of the MoPoE-MIMIC model the benchmark runs.

It follows the published architecture (Jimmy2027/MoPoE-MIMIC: the resnet
image networks at 128 px, the word-128 and char-1024 text networks, the
joint_elbo objective with a product of experts per subset) in float32, with
no kernel, graph or fused op. It imports nothing of the program under test:
it is held against it. The parameter names are the published module names
(``encoder_pa.feature_extractor.resblock_1.0.conv2.weight``, ...), so that
one set of seeded weights can be loaded into both.

``precision`` selects how every convolution and linear computes:

* ``"float32"``: float32 operands, TF32 off (the reference);
* ``"fp8"``: every tensor the configuration computes in bfloat16 (the
  operands and outputs of convolutions and linears, BatchNorm's outputs,
  each block's output) rounded to float8 e4m3 with a per-tensor scale
  (amax / 448), arithmetic in float32, gradients passed through the
  rounding: the control, one step below that bfloat16.

Dropout masks are drawn by calling dropout on a tensor of ones in
``mask_dtype`` (the dtype the program's activations have there), shape by
shape and in the order of the forward, from the default generator of the
device: the masks are then the ones the program draws from the same seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

A_SKIP, B_SKIP = 2.0, 0.3
DROPOUT = 0.5
IMG_SCALE = 0.75  # the Laplace scale of the image likelihood
POE_EPS = 1e-8
FP8_MAX = 448.0
MODALITIES = ("PA", "Lateral", "text")
SUFFIX = {"PA": "pa", "Lateral": "lat", "text": "text"}


class Numerics:
    """How a forward computes: the operands' precision and the dtype the
    dropout masks are drawn in."""

    def __init__(self, precision: str = "float32", mask_dtype: torch.dtype = torch.bfloat16):
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.precision, self.mask_dtype = precision, mask_dtype

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "float32":
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        return x + (rounded - x.detach())  # the rounded value, the gradient passed through

    def dropout(self, h: torch.Tensor, channels_only: bool) -> torch.Tensor:
        ones = torch.ones(h.shape, dtype=self.mask_dtype, device=h.device)
        if channels_only:
            mask = F.dropout2d(ones, DROPOUT, True)
        else:
            mask = F.dropout(ones, DROPOUT, True)
        return h * mask.to(h.dtype)


def _conv(mod: nn.Module, x: torch.Tensor, nm: Numerics) -> torch.Tensor:
    w, b, x = nm.q(mod.weight), mod.bias, nm.q(x)
    if isinstance(mod, nn.ConvTranspose2d):
        y = F.conv_transpose2d(x, w, b, mod.stride, mod.padding, mod.output_padding)
    elif isinstance(mod, nn.ConvTranspose1d):
        y = F.conv_transpose1d(x, w, b, mod.stride, mod.padding, mod.output_padding)
    elif isinstance(mod, nn.Conv2d):
        y = F.conv2d(x, w, b, mod.stride, mod.padding)
    elif isinstance(mod, nn.Conv1d):
        y = F.conv1d(x, w, b, mod.stride, mod.padding)
    elif isinstance(mod, nn.Linear):
        y = F.linear(x, w, b)
    else:
        raise TypeError(type(mod))
    return nm.q(y)


def _bn(mod: nn.Module, x: torch.Tensor, training: bool, nm: Numerics) -> torch.Tensor:
    if training:
        y = F.batch_norm(x, None, None, mod.weight, mod.bias, True, 0.0, mod.eps)
    else:
        y = F.batch_norm(x, mod.running_mean, mod.running_var, mod.weight, mod.bias, False,
                         0.0, mod.eps)
    return nm.q(y)


class Block(nn.Module):
    """Pre-activation residual block: BN → ReLU → 1×1 conv → dropout → BN →
    ReLU → k conv → dropout, plus a conv + BN shortcut, as a·shortcut + b·h."""

    def __init__(self, cin: int, cout: int, k: int, s: int, p: int, *, dims: int,
                 transpose: bool, bias: bool):
        super().__init__()
        bn = nn.BatchNorm2d if dims == 2 else nn.BatchNorm1d
        if transpose:
            conv = nn.ConvTranspose2d if dims == 2 else nn.ConvTranspose1d
        else:
            conv = nn.Conv2d if dims == 2 else nn.Conv1d
        self.dims = dims
        self.bn1 = bn(cin)
        self.conv1 = conv(cin, cin, 1, 1, 0, bias=bias)
        self.bn2 = bn(cin)
        self.conv2 = conv(cin, cout, k, s, p, bias=bias)
        short = nn.Sequential(conv(cin, cout, k, s, p, bias=True), bn(cout))
        setattr(self, "upsample" if transpose else "downsample", short)
        self._short = "upsample" if transpose else "downsample"

    def run(self, x: torch.Tensor, nm: Numerics, training: bool) -> torch.Tensor:
        h = _conv(self.conv1, torch.relu(_bn(self.bn1, x, training, nm)), nm)
        if training:
            h = nm.dropout(h, self.dims == 2)
        h = _conv(self.conv2, torch.relu(_bn(self.bn2, h, training, nm)), nm)
        if training:
            h = nm.dropout(h, self.dims == 2)
        conv, bn = getattr(self, self._short)
        return nm.q(A_SKIP * _bn(bn, _conv(conv, x, nm), training, nm) + B_SKIP * h)


def _wrap(b: Block) -> nn.Sequential:
    return nn.Sequential(b)


def _run_blocks(blocks: List[nn.Sequential], h, nm, training):
    for b in blocks:
        h = b[0].run(h, nm, training)
    return h


class Compressor(nn.Module):
    def __init__(self, cin: int, d: int):
        super().__init__()
        self.content_mu = nn.Linear(cin, d)
        self.content_logvar = nn.Linear(cin, d)

    def run(self, h, nm):
        h = h.reshape(h.shape[0], -1)
        return _conv(self.content_mu, h, nm), _conv(self.content_logvar, h, nm)


# ---------------------------------------------------------------- images

class ImgFeatures(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.conv1 = nn.Conv2d(1, d, 3, 2, 1, bias=False)
        widths = [d, 2 * d, 3 * d, 4 * d, 5 * d]
        for i in range(1, 5):
            setattr(self, f"resblock_{i}", _wrap(Block(widths[i - 1], widths[i], 4, 2, 1,
                                                       dims=2, transpose=False, bias=False)))
        self.resblock_5 = _wrap(Block(5 * d, 5 * d, 4, 2, 0, dims=2, transpose=False,
                                      bias=False))

    def run(self, x, nm, training):
        h = _conv(self.conv1, x, nm)
        return _run_blocks([getattr(self, f"resblock_{i}") for i in range(1, 6)], h, nm,
                           training)


class ImgEncoder(nn.Module):
    def __init__(self, d: int, class_dim: int):
        super().__init__()
        self.feature_extractor = ImgFeatures(d)
        self.feature_compressor = Compressor(5 * d, class_dim)

    def run(self, x, nm, training):
        return self.feature_compressor.run(self.feature_extractor.run(x, nm, training), nm)


class ImgGenerator(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        geo = [(5 * d, 4 * d, 1, 0), (4 * d, 3 * d, 2, 1), (3 * d, 2 * d, 2, 1),
               (2 * d, d, 2, 1), (d, d, 2, 1)]
        layers = [_wrap(Block(ci, co, 4, s, p, dims=2, transpose=True, bias=False))
                  for ci, co, s, p in geo]
        layers.append(nn.ConvTranspose2d(d, 1, 3, 2, 1, output_padding=1, bias=True))
        self.generator = nn.Sequential(*layers)

    def run(self, h, nm, training):
        h = _run_blocks(list(self.generator)[:-1], h, nm, training)
        return _conv(self.generator[-1], h, nm)


class ImgDecoder(nn.Module):
    def __init__(self, d: int, class_dim: int):
        super().__init__()
        self.feature_generator = nn.Linear(class_dim, 5 * d)
        self.img_generator = ImgGenerator(d)

    def run(self, z, nm, training):
        f = _conv(self.feature_generator, z, nm)
        return self.img_generator.run(f.reshape(f.shape[0], -1, 1, 1), nm, training)


# ---------------------------------------------------------------- text

class WordFeatures(nn.Module):
    def __init__(self, d: int, vocab: int):
        super().__init__()
        self.embedding = nn.Embedding(vocab, d)
        self.conv1 = nn.Conv1d(d, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d]
        for i in range(1, 7):
            setattr(self, f"resblock_{i}", _wrap(Block(widths[i - 1], widths[i], 4, 2, 1,
                                                       dims=1, transpose=False, bias=True)))

    def run(self, ids, nm, training):
        ids = ids.long()
        emb = self.embedding.weight[ids] * (ids != 0).unsqueeze(-1).to(torch.float32)
        h = _conv(self.conv1, emb.transpose(1, 2), nm)
        return _run_blocks([getattr(self, f"resblock_{i}") for i in range(1, 7)], h, nm,
                           training)


class WordGenerator(nn.Module):
    def __init__(self, d: int, vocab: int):
        super().__init__()
        widths = [5 * d, 5 * d, 5 * d, 5 * d, 4 * d, 4 * d, d]
        geo = [(1, 0)] + [(2, 1)] * 5
        layers = [_wrap(Block(widths[i], widths[i + 1], 4, *geo[i], dims=1, transpose=True,
                              bias=True)) for i in range(6)]
        layers.append(nn.Conv1d(d, vocab, 1, 1, 0, bias=True))
        self.generator = nn.Sequential(*layers)

    def run(self, h, nm, training):
        h = _run_blocks(list(self.generator)[:-1], h, nm, training)
        logits = _conv(self.generator[-1], h, nm).transpose(1, 2)  # [B, L, V]
        return torch.log_softmax(logits, dim=-1)


class CharFeatures(nn.Module):
    def __init__(self, d: int, classes: int):
        super().__init__()
        self.conv1 = nn.Conv1d(classes, d, 4, 2, 1, bias=True)
        widths = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d, 5 * d]
        for i in range(1, 8):
            setattr(self, f"resblock_{i}", _wrap(Block(widths[i - 1], widths[i], 4, 2, 1,
                                                       dims=1, transpose=False, bias=True)))
        self.resblock_8 = _wrap(Block(5 * d, 5 * d, 4, 2, 0, dims=1, transpose=False,
                                      bias=True))

    def run(self, onehot, nm, training):
        h = _conv(self.conv1, onehot.transpose(1, 2), nm)
        return _run_blocks([getattr(self, f"resblock_{i}") for i in range(1, 9)], h, nm,
                           training)


class CharGenerator(nn.Module):
    def __init__(self, d: int, classes: int):
        super().__init__()
        self.resblock_1 = _wrap(Block(5 * d, 5 * d, 4, 1, 0, dims=1, transpose=True,
                                      bias=True))
        widths = [5 * d, 5 * d, 5 * d, 4 * d, 4 * d, 3 * d, 2 * d, d]
        for i in range(2, 9):
            setattr(self, f"resblock_{i}", _wrap(Block(widths[i - 2], widths[i - 1], 4, 2, 1,
                                                       dims=1, transpose=True, bias=True)))
        self.conv2 = nn.ConvTranspose1d(d, classes, 4, 2, 1, bias=True)

    def run(self, h, nm, training):
        h = _run_blocks([getattr(self, f"resblock_{i}") for i in range(1, 9)], h, nm,
                        training)
        return torch.log_softmax(_conv(self.conv2, h, nm).transpose(1, 2), dim=-1)


class TextEncoder(nn.Module):
    def __init__(self, d: int, class_dim: int, encoding: str, classes: int):
        super().__init__()
        self.feature_extractor = (WordFeatures(d, classes) if encoding == "word"
                                  else CharFeatures(d, classes))
        self.feature_compressor = Compressor(5 * d, class_dim)

    def run(self, x, nm, training):
        return self.feature_compressor.run(self.feature_extractor.run(x, nm, training), nm)


class TextDecoder(nn.Module):
    def __init__(self, d: int, class_dim: int, encoding: str, classes: int):
        super().__init__()
        self.feature_generator = nn.Linear(class_dim, 5 * d)
        self.text_generator = (WordGenerator(d, classes) if encoding == "word"
                               else CharGenerator(d, classes))

    def run(self, z, nm, training):
        f = _conv(self.feature_generator, z, nm)
        return self.text_generator.run(f.reshape(f.shape[0], -1, 1), nm, training)


# ---------------------------------------------------------------- the model

def subsets(names=MODALITIES) -> Dict[str, Tuple[int, ...]]:
    """Every non-empty subset of the modalities, by size, each keyed by its
    sorted member names joined by '_' (the published key order)."""
    import itertools

    out = {}
    for n in range(1, len(names) + 1):
        for combo in itertools.combinations(range(len(names)), n):
            out["_".join(sorted(names[i] for i in combo))] = combo
    return out


def mixture_rows(batch: int, k: int) -> torch.Tensor:
    """Row b of the joint comes from component c(b): the batch split into k
    parts of floor(batch / k) rows, the last taking the rest."""
    rows, start = [], 0
    for c in range(k):
        end = batch if c == k - 1 else start + batch // k
        rows += [c * batch + b for b in range(start, end)]
        start = end
    return torch.tensor(rows)


class MMVae(nn.Module):
    """The trimodal VAE under joint_elbo."""

    def __init__(self, sizes: dict):
        super().__init__()
        d_img, d_txt, cd = sizes["DIM_img"], sizes["DIM_text"], sizes["class_dim"]
        enc, classes = sizes["text_encoding"], sizes["text_classes"]
        self.sizes = sizes
        for m in ("PA", "Lateral"):
            setattr(self, f"encoder_{SUFFIX[m]}", ImgEncoder(d_img, cd))
            setattr(self, f"decoder_{SUFFIX[m]}", ImgDecoder(d_img, cd))
        self.encoder_text = TextEncoder(d_txt, cd, enc, classes)
        self.decoder_text = TextDecoder(d_txt, cd, enc, classes)

    def encoder(self, m):
        return getattr(self, f"encoder_{SUFFIX[m]}")

    def decoder(self, m):
        return getattr(self, f"decoder_{SUFFIX[m]}")

    def subset_posteriors(self, batch, nm: Numerics, training: bool, present=MODALITIES):
        """{subset key: (mu, logvar)} by a product of the members' experts."""
        post = {m: self.encoder(m).run(batch[m], nm, training) for m in present}
        out = {}
        for key, members in subsets(present).items():
            t = [1.0 / (torch.exp(post[present[i]][1]) + POE_EPS) for i in members]
            t_sum = sum(t)
            mu = sum(post[present[i]][0] * ti for i, ti in zip(members, t)) / t_sum
            out[key] = (mu, torch.log(1.0 / t_sum))
        return out

    def decode(self, z, nm: Numerics, training: bool) -> Dict[str, torch.Tensor]:
        return {m: self.decoder(m).run(z, nm, training) for m in MODALITIES}


def objective(model: MMVae, batch: Dict[str, torch.Tensor], eps: torch.Tensor,
              nm: Numerics, weights: dict) -> torch.Tensor:
    """The joint_elbo loss of one training batch: Σ_m w_m · (−log p(x_m|z))
    + β·β_content · Σ_S KL(q_S ‖ N(0, I)) / |S|, sums over the batch divided
    by the batch size; z from the joint mixture, with noise ``eps``."""
    bsz = eps.shape[0]
    post = model.subset_posteriors(batch, nm, True)
    mus = torch.stack([mu for mu, _ in post.values()])
    lvs = torch.stack([lv for _, lv in post.values()])
    k = mus.shape[0]
    kl = -0.5 * torch.sum(1.0 - torch.exp(lvs) - mus ** 2 + lvs, dim=(1, 2)) / bsz
    divergence = kl.sum() / k
    rows = mixture_rows(bsz, k).to(mus.device)
    mu_j = mus.flatten(0, 1).index_select(0, rows)
    lv_j = lvs.flatten(0, 1).index_select(0, rows)
    z = mu_j + eps * torch.exp(0.5 * lv_j)
    rec = model.decode(z, nm, True)
    nll = 0.0
    for m in ("PA", "Lateral"):
        lp = -math.log(2.0 * IMG_SCALE) - torch.abs(batch[m] - rec[m]) / IMG_SCALE
        nll = nll + weights["rec"] * -(lp.sum() / bsz)
    text = batch["text"]
    if model.sizes["text_encoding"] == "word":
        lp = torch.gather(rec["text"], -1, text.long().unsqueeze(-1)).sum()
    else:
        lp = (text * rec["text"]).sum()
    nll = nll + weights["rec"] * -(lp / bsz)
    return nll + weights["beta"] * weights["beta_content"] * divergence
