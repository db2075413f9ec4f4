"""The arithmetic of ``metrics/_work.py`` against the port's modules and
chip_smoke's bounds, on the CPU (run by hand: ``python -m pytest
bench_port/tests -q``; not part of the repository's tier-1 tests)."""

from __future__ import annotations

import math

import pytest
import torch
from torch import nn

import _small  # noqa: F401  (paths)
from metrics import _work

from harness import load_json, BENCH_DIR


def hook_count(model: nn.Module, run) -> int:
    """Operations of every convolution, transposed convolution and linear
    that ``run`` calls, counted by forward hooks from their shapes."""
    total = [0]

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            total[0] += 2 * x.numel() * mod.out_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            total[0] += 2 * out.numel() * mod.in_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * x.numel() * mod.out_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d,
                                 nn.ConvTranspose2d, nn.Linear))]
    with torch.no_grad():
        run()
    for h in handles:
        h.remove()
    return total[0]


@pytest.mark.parametrize("config", ["mopoe_word128", "mopoe_char1024"])
def test_forward_ops_match_the_ports_modules(config):
    from mopoe_mimic_tpu_torch.config import MopoeConfig
    from mopoe_mimic_tpu_torch.models.mmvae import MMVae

    keys = dict(load_json(BENCH_DIR / "configs" / f"{config}.json")["config"], batch_size=2,
                compute_dtype="float32", bn_compute_dtype="float32")
    cfg = MopoeConfig(**keys)
    model = MMVae(cfg).train()
    b = 2
    text = (torch.randint(1, 50, (b, 128)) if cfg.text_encoding == "word" else
            torch.nn.functional.one_hot(torch.randint(0, 71, (b, 1024)), 71).float())
    batch = {"PA": torch.rand(b, 1, 128, 128), "Lateral": torch.rand(b, 1, 128, 128),
             "text": text}
    counted = hook_count(model, lambda: model(batch, generator=torch.Generator().manual_seed(0)))
    assert sum(_work.forward_ops(keys).values()) == counted


def test_k1_bound_is_chip_smokes():
    import chip_smoke

    cfg = {"batch_size": 256, "class_dim": 64}
    m, n_sub, members, b, d = 3, 7, 12, 256, 64
    ops = b * d * (3 * m + 2 * members + 3 * n_sub)
    fwd = chip_smoke.least_time((2 * m + 2 * n_sub) * b * d * 4, ops, torch.float32)
    bwd = chip_smoke.least_time((2 * m + 2 * n_sub + 2 * m) * b * d * 4, 2 * ops, torch.float32)
    assert _work.k1_bound_seconds(cfg) * 1e3 == pytest.approx(
        fwd["bound_ms"] + bwd["bound_ms"], rel=1e-12)


def test_k2_bytes_and_operations_are_chip_smokes():
    import chip_smoke

    cfg = {"batch_size": 2, "DIM_text": 16, "vocab_size": 37}
    r, c, v = 2 * 128, 16, 37
    h = torch.zeros(r, c, dtype=torch.bfloat16)
    k = torch.zeros(c, v, dtype=torch.bfloat16)
    bias, t, lse, g = torch.zeros(v), torch.zeros(r, dtype=torch.int32), torch.zeros(r), \
        torch.zeros(r)
    dw, db = torch.zeros(c, v), torch.zeros(v)
    product = 2 * r * c * v
    smoke = [(chip_smoke.nbytes(h, k, bias, t) + 2 * r * 4, product),
             (chip_smoke.nbytes(h, k, bias, t, lse, g, h), 2 * product),
             (chip_smoke.nbytes(h, k, bias, t, lse, g, dw, db), 2 * product)]
    ours = [(moved, ops) for _, moved, ops, _ in _work.k2_pieces(cfg)]
    assert ours == smoke
    assert all(e == r * v for *_, e in _work.k2_pieces(cfg))


def test_train_step_is_three_forwards():
    cfg = load_json(BENCH_DIR / "configs" / "mopoe_word128.json")["config"]
    assert _work.train_step_ops(cfg) == 3 * sum(_work.forward_ops(cfg).values())
