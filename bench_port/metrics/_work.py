"""The work a configuration asks of the card, from its shapes alone: the
operations of a training step, and the bytes and operations of the subset
product of experts (K1) and of the word text head (K2). Counts follow the
published architecture, not the program's modules: a change that fuses or
replaces a module leaves them as they are.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W power limit;
the exponentials' rate is the Hopper SM's 16 a clock on each of 132 SMs
(the Hopper white paper) at the card's maximum SM clock.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12
SMS, EX2_PER_SM_CLOCK = 132, 16
DEFAULT_SM_CLOCK_HZ = 1980e6  # the H100 SXM's maximum, where nvidia-smi gives none


def conv(b, cin, cout, taps, out_positions) -> int:
    return 2 * b * cout * out_positions * cin * taps


def conv_t(b, cin, cout, taps, in_positions) -> int:
    return 2 * b * cin * in_positions * cout * taps


def linear(b, cin, cout) -> int:
    return 2 * b * cin * cout


def _block(b, cin, cout, taps, n_in, n_out, transpose) -> int:
    """A residual block: the 1×1 conv at the input's positions, the k conv
    and the shortcut's k conv of the same shape."""
    main = conv_t(b, cin, cout, taps, n_in) if transpose else conv(b, cin, cout, taps, n_out)
    return conv(b, cin, cin, 1, n_in) + 2 * main


def image_layers(b: int, d: int, cd: int, size: int = 128) -> Dict[str, int]:
    if size != 128:
        raise NotImplementedError(f"image size {size}")
    enc = conv(b, 1, d, 9, 64 * 64)
    for cin, cout, n_in, n_out in ((d, 2 * d, 64, 32), (2 * d, 3 * d, 32, 16),
                                   (3 * d, 4 * d, 16, 8), (4 * d, 5 * d, 8, 4),
                                   (5 * d, 5 * d, 4, 1)):
        enc += _block(b, cin, cout, 16, n_in * n_in, n_out * n_out, False)
    enc += 2 * linear(b, 5 * d, cd)
    dec = linear(b, cd, 5 * d)
    for cin, cout, n_in in ((5 * d, 4 * d, 1), (4 * d, 3 * d, 4), (3 * d, 2 * d, 8),
                            (2 * d, d, 16), (d, d, 32)):
        dec += _block(b, cin, cout, 16, n_in * n_in, None, True)
    dec += conv_t(b, d, 1, 9, 64 * 64)
    return {"image_encoder": enc, "image_decoder": dec}


def text_layers(b: int, d: int, cd: int, encoding: str, vocab: int) -> Dict[str, int]:
    if encoding == "word":
        enc = conv(b, d, d, 4, 64)
        widths, n = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d], 64
        for i in range(1, 7):
            enc += _block(b, widths[i - 1], widths[i], 4, n, n // 2, False)
            n //= 2
        dec = linear(b, cd, 5 * d)
        widths, n = [5 * d, 5 * d, 5 * d, 5 * d, 4 * d, 4 * d, d], 1
        for i in range(6):
            dec += _block(b, widths[i], widths[i + 1], 4, n, None, True)
            n = 4 if n == 1 else 2 * n
        head = conv(b, d, vocab, 1, 128)
    else:
        enc = conv(b, 71, d, 4, 512)
        widths, n = [d, 2 * d, 3 * d, 4 * d, 4 * d, 4 * d, 5 * d, 5 * d], 512
        for i in range(1, 8):
            enc += _block(b, widths[i - 1], widths[i], 4, n, n // 2, False)
            n //= 2
        enc += _block(b, 5 * d, 5 * d, 4, 4, 1, False)
        dec = linear(b, cd, 5 * d) + _block(b, 5 * d, 5 * d, 4, 1, None, True)
        widths, n = [5 * d, 5 * d, 5 * d, 4 * d, 4 * d, 3 * d, 2 * d, d], 4
        for i in range(2, 9):
            dec += _block(b, widths[i - 2], widths[i - 1], 4, n, None, True)
            n *= 2
        head = conv_t(b, d, 71, 4, 512)
    enc += 2 * linear(b, 5 * d, cd)
    return {"text_encoder": enc, "text_decoder": dec, "text_head": head}


def forward_ops(cfg: dict) -> Dict[str, int]:
    """Operations (2 per multiply-add) of one forward at the configuration's
    batch: every convolution, transposed convolution and linear."""
    b, cd = cfg["batch_size"], cfg["class_dim"]
    img = image_layers(b, cfg["DIM_img"], cd, cfg["img_size"])
    out = {k: 2 * v for k, v in img.items()}  # two image modalities
    out.update(text_layers(b, cfg["DIM_text"], cd, cfg["text_encoding"], cfg["vocab_size"]))
    return out


def train_step_ops(cfg: dict) -> int:
    """A training step's operations: the forward's three times over (the
    backward's products for the inputs' and the weights' gradients)."""
    return 3 * sum(forward_ops(cfg).values())


def least_seconds(moved: float, ops: float, peak_ops: float, exps: float = 0,
                  sm_clock_hz: float = DEFAULT_SM_CLOCK_HZ) -> float:
    """The least time of a piece of work: the largest of its bytes at the
    HBM's rate, its operations at ``peak_ops`` and its exponentials at the
    SFUs' rate."""
    return max(moved / HBM_BYTES_PER_S, ops / peak_ops,
               exps / (SMS * EX2_PER_SM_CLOCK * sm_clock_hz))


def k1_bound_seconds(cfg: dict, modalities: int = 3) -> float:
    """K1, the product of experts of every subset, forward and backward, at
    float32: per (row, latent) M precisions (an exponential, an add, a
    divide), the members' sums of T and mu·T, then a divide and a log a
    subset; the backward recomputes and does as much again. Bytes: the
    experts' mu and logvar in, every subset's out; the backward reads both
    and the subsets' gradients and writes the experts'."""
    b, d, m = cfg["batch_size"], cfg["class_dim"], modalities
    n_sub, members = 2 ** m - 1, m * 2 ** (m - 1)
    ops = b * d * (3 * m + 2 * members + 3 * n_sub)
    fwd_bytes = (2 * m + 2 * n_sub) * b * d * 4
    bwd_bytes = (2 * m + 2 * n_sub + 2 * m) * b * d * 4
    return (least_seconds(fwd_bytes, ops, PEAK_F32_OPS_PER_S)
            + least_seconds(bwd_bytes, 2 * ops, PEAK_F32_OPS_PER_S))


def k2_pieces(cfg: dict) -> List[Tuple[str, float, float, float]]:
    """K2, the word head's log-probabilities and their gradients, as
    (piece, bytes, operations, exponentials): R = batch × 128 rows of C
    features against V words in bfloat16 (the head's kernel C × V), the
    bias, targets and gradients float32. The forward's logits and log-sum-
    exp; the backward's dh and dW, db, each recomputing the logits."""
    r, c, v = cfg["batch_size"] * 128, cfg["DIM_text"], cfg["vocab_size"]
    h, w, bias, t, row = r * c * 2, c * v * 2, v * 4, r * 4, r * 4
    product, exps = 2 * r * c * v, r * v
    return [("forward", h + w + bias + t + 2 * row, product, exps),
            ("backward dh", h + w + bias + t + 2 * row + h, 2 * product, exps),
            ("backward dW", h + w + bias + t + 2 * row + c * v * 4 + v * 4, 2 * product,
             exps)]


def k2_bound_seconds(cfg: dict, sm_clock_hz: float = DEFAULT_SM_CLOCK_HZ) -> float:
    return sum(least_seconds(moved, ops, PEAK_BF16_OPS_PER_S, exps, sm_clock_hz)
               for _, moved, ops, exps in k2_pieces(cfg))
