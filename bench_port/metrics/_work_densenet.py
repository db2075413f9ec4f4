"""The work of a configuration whose X-ray encoders are DenseNet-121, from
its published shapes alone (Huang et al., arXiv:1608.06993; torchvision's
``densenet121``): the operations of a training step, and the bytes the
dense layers' concatenations read and write. As in ``_work.py``, counts
follow the architecture, not the program's modules.

Operations count every convolution, transposed convolution and linear, 2
a multiply-add, a training step the forward's three times over
(``_work.train_step_ops``' rule). At 224 px and 3 channels the trunk and
a 1000-way classifier are 2.834 G multiply-adds, torchvision's figure for
``densenet121``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from metrics import _work

GROWTH, BOTTLENECK = 32, 128
BLOCK_CONFIG = (6, 12, 24, 16)
STEM, FEATURES = 64, 1024
BF16_BYTES = 2
CONCAT_KERNEL = "CatArrayBatchedCopy"  # ATen's torch.cat kernels on CUDA


def dense_layers(size: int) -> Iterator[Tuple[int, int, int]]:
    """(block, input channels, positions) of each dense layer of a trunk
    fed ``size`` × ``size`` images: the stem's 7×7/2 conv and 3×3/2 pool
    leave size/4 on a side, each transition halves it."""
    side, channels = size // 4, STEM
    for b, n in enumerate(BLOCK_CONFIG, start=1):
        for i in range(n):
            yield b, channels + i * GROWTH, side * side
        channels += n * GROWTH
        if b < len(BLOCK_CONFIG):
            channels //= 2
            side //= 2


def trunk_ops(b: int, size: int, channels_in: int = 3) -> Dict[str, int]:
    """Operations of one trunk's forward over ``b`` images by part: the
    stem's conv, the dense layers' 1×1 and 3×3 convs, the transitions' 1×1
    convs (at their input's positions, before the pool)."""
    layers = list(dense_layers(size))
    ends = {blk: (c + GROWTH, s) for blk, c, s in layers}  # each block's output
    return {"stem": _work.conv(b, channels_in, STEM, 49, (size // 2) ** 2),
            "dense": sum(_work.conv(b, c, BOTTLENECK, 1, s)
                         + _work.conv(b, BOTTLENECK, GROWTH, 9, s) for _, c, s in layers),
            "transition": sum(_work.conv(b, c, c // 2, 1, s) for blk, (c, s) in ends.items()
                              if blk < len(BLOCK_CONFIG))}


def image_decoder_ops(b: int, d: int, cd: int, size: int) -> int:
    """The 64-, 128- or 256-px image generator (ConvNetworksImgMimic.py's
    DataGeneratorImg): a linear to 5·d, residual transposed blocks from 1
    position to size/2 on a side, a 3×3 transposed conv to ``size``."""
    geo = [(5 * d, 4 * d, 1), (4 * d, 3 * d, 4), (3 * d, 2 * d, 8), (2 * d, d, 16)]
    geo += [(d, d, 32), (d, d, 64)][:{64: 0, 128: 1, 256: 2}[size]]
    ops = _work.linear(b, cd, 5 * d)
    for cin, cout, n_in in geo:
        ops += _work._block(b, cin, cout, 16, n_in * n_in, None, True)
    return ops + _work.conv_t(b, d, 1, 9, (size // 2) ** 2)


def forward_ops(cfg: dict) -> Dict[str, int]:
    """Operations of one forward at the configuration's batch: two X-ray
    encoders (trunk, ``proj``, the compressor's two heads), two image
    decoders, the text networks."""
    b, d, cd, size = cfg["batch_size"], cfg["DIM_img"], cfg["class_dim"], cfg["img_size"]
    enc = (sum(trunk_ops(b, size).values()) + _work.linear(b, FEATURES, 5 * d)
           + 2 * _work.linear(b, 5 * d, cd))
    out = {"image_encoder": 2 * enc, "image_decoder": 2 * image_decoder_ops(b, d, cd, size)}
    out.update(_work.text_layers(b, cfg["DIM_text"], cd, cfg["text_encoding"],
                                 cfg["vocab_size"]))
    return out


def train_step_ops(cfg: dict) -> int:
    return 3 * sum(forward_ops(cfg).values())


def concat_elements(b: int, size: int) -> int:
    """Elements the concatenations of one trunk's forward write: each dense
    layer's input and its 32 new maps."""
    return sum(b * (c + GROWTH) * s for _, c, s in dense_layers(size))


def concat_bytes(cfg: dict) -> int:
    """Bytes the concatenations of a training step read and write: both
    trunks' forwards, each element read once and written once in bfloat16
    (the backward of a concatenation is a view of its gradient)."""
    return 2 * 2 * BF16_BYTES * concat_elements(cfg["batch_size"], cfg["img_size"])
