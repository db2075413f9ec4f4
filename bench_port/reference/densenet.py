"""Plain PyTorch reference of MoPoE with DenseNet-121 X-ray encoders.

The model of ``mmvae.py`` with each X-ray encoder's feature extractor
replaced by DenseNet-121 and a linear ``proj`` (Huang et al.,
arXiv:1608.06993; torchvision's ``densenet121``, as MoPoE-MIMIC's
``--feature_extractor_img densenet`` builds it, mimic/networks/CheXNet.py:
85-106): the grayscale input repeated to 3 channels; a 7×7/2 conv to 64,
BN, ReLU and a 3×3/2 max pool; dense blocks of 6, 12, 24 and 16 layers,
each layer BN → ReLU → 1×1 conv to 128 → BN → ReLU → 3×3 conv to 32 on
the concatenation of every earlier feature map of its block; between
blocks BN → ReLU → a 1×1 conv that halves the channels → 2×2 average
pool; then BN, ReLU, a global average pool to 1024 and ``proj`` to
5·DIM_img. The image generators are ``mmvae.py``'s at the configuration's
size: 64 px drops the 128-px geometry's last block, 256 px adds one more
``(d, d, 2, 1)`` block. Text networks, compressors, the objective and
``Numerics`` are ``mmvae.py``'s.

Float32, no kernel, graph or fused op; it imports nothing of the program
under test. ``Numerics.q`` rounds every convolution's and linear's
operands and output and every BatchNorm's output, as in ``mmvae.py``.

So that a batch of 256 at 256 px fits in float32, each dense layer runs
under ``torch.utils.checkpoint`` (recomputed in the backward, the same
arithmetic, no dropout inside) on the block's feature maps as separate
tensors, its concatenation made inside. The batch is never split:
BatchNorm's statistics span it. ``run(..., track=True)`` runs without
checkpoints and advances the running statistics (momentum 0.1, the
variance unbiased), for the CPU tests.
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from reference import mmvae as R
from reference.training import model_sizes as resnet_sizes

GROWTH, BOTTLENECK = 32, 128
BLOCK_CONFIG = (6, 12, 24, 16)
STEM, FEATURES = 64, 1024
MOMENTUM = 0.1


def model_sizes(cfg: dict) -> dict:
    """``training.model_sizes`` and the image size."""
    return dict(resnet_sizes(cfg), img_size=cfg["img_size"])


def _norm(mod: nn.BatchNorm2d, x, training: bool, nm: R.Numerics, track: bool):
    if training and track:
        return nm.q(F.batch_norm(x, mod.running_mean, mod.running_var, mod.weight, mod.bias,
                                 True, MOMENTUM, mod.eps))
    return R._bn(mod, x, training, nm)


class DenseLayer(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm1 = nn.BatchNorm2d(cin)
        self.conv1 = nn.Conv2d(cin, BOTTLENECK, 1, bias=False)
        self.norm2 = nn.BatchNorm2d(BOTTLENECK)
        self.conv2 = nn.Conv2d(BOTTLENECK, GROWTH, 3, 1, 1, bias=False)

    def run(self, nm, training, track, *features):
        x = torch.cat(features, 1)
        h = R._conv(self.conv1, torch.relu(_norm(self.norm1, x, training, nm, track)), nm)
        return R._conv(self.conv2, torch.relu(_norm(self.norm2, h, training, nm, track)), nm)


class Transition(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.norm = nn.BatchNorm2d(cin)
        self.conv = nn.Conv2d(cin, cin // 2, 1, bias=False)

    def run(self, x, nm, training, track):
        h = R._conv(self.conv, torch.relu(_norm(self.norm, x, training, nm, track)), nm)
        return F.avg_pool2d(h, 2, 2)


class Block(nn.Module):
    def __init__(self, n_layers: int, cin: int):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"denselayer{i + 1}", DenseLayer(cin + i * GROWTH))

    def run(self, x, nm, training, track):
        features = [x]
        recompute = torch.is_grad_enabled() and not track
        for i in range(self.n_layers):
            layer = getattr(self, f"denselayer{i + 1}")
            fn = partial(layer.run, nm, training, track)
            h = checkpoint(fn, *features, use_reentrant=False) if recompute else fn(*features)
            features.append(h)
        return torch.cat(features, 1)


class Trunk(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv0 = nn.Conv2d(3, STEM, 7, 2, 3, bias=False)
        self.norm0 = nn.BatchNorm2d(STEM)
        c = STEM
        for b, n in enumerate(BLOCK_CONFIG, start=1):
            setattr(self, f"denseblock{b}", Block(n, c))
            c += n * GROWTH
            if b < len(BLOCK_CONFIG):
                setattr(self, f"transition{b}", Transition(c))
                c //= 2
        self.norm5 = nn.BatchNorm2d(c)

    def run(self, x, nm, training, track=False):
        x = x.expand(-1, 3, -1, -1)
        h = torch.relu(_norm(self.norm0, R._conv(self.conv0, x, nm), training, nm, track))
        h = F.max_pool2d(h, 3, 2, 1)
        for b in range(1, len(BLOCK_CONFIG) + 1):
            h = getattr(self, f"denseblock{b}").run(h, nm, training, track)
            if b < len(BLOCK_CONFIG):
                h = getattr(self, f"transition{b}").run(h, nm, training, track)
        return torch.relu(_norm(self.norm5, h, training, nm, track)).mean(dim=(2, 3))


class Features(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.features = Trunk()
        self.proj = nn.Linear(FEATURES, 5 * d)

    def run(self, x, nm, training, track=False):
        return R._conv(self.proj, self.features.run(x, nm, training, track), nm)


class Encoder(nn.Module):
    def __init__(self, d: int, class_dim: int):
        super().__init__()
        self.feature_extractor = Features(d)
        self.feature_compressor = R.Compressor(5 * d, class_dim)

    def run(self, x, nm, training, track=False):
        return self.feature_compressor.run(self.feature_extractor.run(x, nm, training, track),
                                           nm)


def generator_geometry(d: int, img_size: int):
    """The image generator's blocks (cin, cout, stride, padding) at
    ``img_size`` (ConvNetworksImgMimic.py's DataGeneratorImg)."""
    geo = [(5 * d, 4 * d, 1, 0), (4 * d, 3 * d, 2, 1), (3 * d, 2 * d, 2, 1), (2 * d, d, 2, 1)]
    return geo + [(d, d, 2, 1)] * {64: 0, 128: 1, 256: 2}[img_size]


class ImgGenerator(R.ImgGenerator):
    def __init__(self, d: int, img_size: int):
        nn.Module.__init__(self)
        layers = [R._wrap(R.Block(ci, co, 4, s, p, dims=2, transpose=True, bias=False))
                  for ci, co, s, p in generator_geometry(d, img_size)]
        layers.append(nn.ConvTranspose2d(d, 1, 3, 2, 1, output_padding=1, bias=True))
        self.generator = nn.Sequential(*layers)


class ImgDecoder(R.ImgDecoder):
    def __init__(self, d: int, class_dim: int, img_size: int):
        nn.Module.__init__(self)
        self.feature_generator = nn.Linear(class_dim, 5 * d)
        self.img_generator = ImgGenerator(d, img_size)


class MMVae(R.MMVae):
    """The trimodal VAE under joint_elbo with DenseNet-121 X-ray encoders."""

    def __init__(self, sizes: dict):
        nn.Module.__init__(self)
        d_img, d_txt, cd = sizes["DIM_img"], sizes["DIM_text"], sizes["class_dim"]
        enc, classes = sizes["text_encoding"], sizes["text_classes"]
        self.sizes = sizes
        for m in ("PA", "Lateral"):
            setattr(self, f"encoder_{R.SUFFIX[m]}", Encoder(d_img, cd))
            setattr(self, f"decoder_{R.SUFFIX[m]}", ImgDecoder(d_img, cd, sizes["img_size"]))
        self.encoder_text = R.TextEncoder(d_txt, cd, enc, classes)
        self.decoder_text = R.TextDecoder(d_txt, cd, enc, classes)


def running_statistics(encoder: Encoder, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The encoder's running statistics after one train-mode forward on x,
    by its state-dict keys (the module itself is left as it was)."""
    before = {k: v.clone() for k, v in encoder.state_dict().items()}
    with torch.no_grad():
        encoder.run(x, R.Numerics(), True, track=True)
    out = {k: v.clone() for k, v in encoder.state_dict().items()
           if k.endswith(("running_mean", "running_var"))}
    encoder.load_state_dict(before)
    return out
