"""The reference's side of a training cell's check: seeded weights, the
first training steps in plain PyTorch (the objective of ``mmvae.py``, its
gradients by autograd, Adam written out), and the numbers compared.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence

import torch

from reference.mmvae import MMVae, Numerics, objective

DROPOUT_SEED_OFFSET = 29  # the default generator, which dropout draws from, takes seed + 29


def model_sizes(cfg: dict) -> dict:
    """The reference's sizes from a configuration file's ``config``."""
    enc = cfg["text_encoding"]
    return {"DIM_img": cfg["DIM_img"], "DIM_text": cfg["DIM_text"],
            "class_dim": cfg["class_dim"], "text_encoding": enc,
            "text_classes": cfg["vocab_size"] if enc == "word" else 71}


def _bound(shape: Sequence[int]) -> float:
    """PyTorch's default init bound of a convolution or linear: 1/sqrt(fan_in),
    fan_in the product of every dimension but the first."""
    return 1.0 / math.sqrt(math.prod(shape[1:]))


def seeded_weights(model: MMVae, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``model``'s state dict, made on
    ``device`` from ``seed`` in two generator calls: the weights and biases
    of convolutions and linears uniform within PyTorch's default bound, the
    embedding standard normal, BatchNorm's scale 1 and shift 0, running
    statistics 0 and 1."""
    gen = torch.Generator(device).manual_seed(seed)
    sd = model.state_dict()
    uniform, normal, bounds = [], [], {}
    owner = dict(model.named_modules())
    for name, t in sd.items():
        mod = owner[name.rsplit(".", 1)[0]]
        if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
            continue
        if isinstance(mod, torch.nn.Embedding):
            normal.append(name)
        else:
            uniform.append(name)
            bounds[name] = _bound(mod.weight.shape)
    out = {}
    total = sum(sd[n].numel() for n in uniform)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    at = 0
    for n in uniform:
        k = sd[n].numel()
        out[n] = (flat[at:at + k] * bounds[n]).reshape(sd[n].shape)
        at += k
    for n in normal:
        out[n] = torch.randn(sd[n].shape, generator=gen, device=device)
    for name, t in sd.items():
        if name in out:
            continue
        leaf = name.rsplit(".", 1)[1]
        fill = {"weight": 1.0, "running_var": 1.0}.get(leaf, 0.0)
        out[name] = torch.full(t.shape, fill, dtype=t.dtype, device=device)
    return out


def reference_steps(cfg: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
                    eps: List[torch.Tensor], seed: int, precision: str = "float32",
                    mask_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Train a fresh reference from ``weights`` for ``len(batches)`` steps:
    the objective, autograd, the warmup ramp and Adam. Returns each step's
    loss, the first step's gradient by parameter and each parameter's
    change after the last step. Dropout draws from the default generator of
    the batches' device, seeded ``seed`` + 29 here."""
    device = eps[0].device
    model = MMVae(model_sizes(cfg)).to(device)
    model.load_state_dict(weights)
    nm = Numerics(precision, mask_dtype)
    if device.type == "cuda":
        torch.cuda.manual_seed(seed + DROPOUT_SEED_OFFSET)
    else:
        torch.manual_seed(seed + DROPOUT_SEED_OFFSET)
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = cfg.get("beta_1", 0.9), cfg.get("beta_2", 0.999)
    base_lr, warm = cfg["initial_learning_rate"], cfg.get("lr_warmup_steps", 0)
    weights_obj = {"rec": 0.33, "beta": cfg.get("beta", 5.0),
                   "beta_content": cfg.get("beta_content", 1.0)}
    losses, first_grad = [], None
    for t, (batch, e) in enumerate(zip(batches, eps), start=1):
        for p in params.values():
            p.grad = None
        loss = objective(model, batch, e, nm, weights_obj)
        loss.backward()
        losses.append(float(loss.detach()))
        lr = base_lr * (min(1.0, t / warm) if warm > 0 else 1.0)
        with torch.no_grad():
            if first_grad is None:
                first_grad = {n: p.grad.detach().clone() for n, p in params.items()}
            for n, p in params.items():
                g = p.grad
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[n] / (1.0 - b2 ** t)).sqrt_().add_(1e-8)
                p.addcdiv_(m[n], denom, value=-lr / (1.0 - b1 ** t))
    change = {n: (p.detach() - start[n]) for n, p in params.items()}
    return {"losses": losses, "grad": first_grad, "change": change}


def _leaf_norms(tree: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(tree[n].double())) for n in names}


def group_losses(per_step: Sequence[float], calls: Sequence[int]) -> List[float]:
    """Per-step losses → the mean of each run of ``calls`` steps, as the
    program's epoch function reports a call's loss."""
    out, at = [], 0
    for n in calls:
        out.append(sum(per_step[at:at + n]) / n)
        at += n
    return out


def compare(ref: dict, prog: dict, skip_share: float = 1e-3) -> dict:
    """The numbers the check compares, from the reference's readings
    (``losses`` a step, ``grad``, ``change``) and the program's (``losses``
    a call of ``calls`` steps, ``grad``, ``change``):

    * ``loss``: the first step's loss, its gap over the reference's;
    * ``loss_2_3``: the mean loss of steps 2 and 3 (one call), its gap;
    * ``grad``: the first gradient, the median leaf's gap of its norm;
    * ``change``: the parameters' change after the third step, the median
      leaf's gap of its norm;

    a leaf's gap over the larger of the reference's norm of that leaf and
    of the median leaf. Leaves whose reference gradient is under
    ``skip_share`` of the median leaf's (zero but for rounding, as a bias
    before a BatchNorm) count in neither. Beside them, for the record: the
    worst leaf of each, with its norms (reference, program, median leaf)."""
    names = sorted(ref["grad"])
    g_ref, g_prog = _leaf_norms(ref["grad"], names), _leaf_norms(prog["grad"], names)
    g_med = statistics.median(g_ref.values())
    kept = [n for n in names if g_ref[n] >= skip_share * g_med]
    c_ref, c_prog = _leaf_norms(ref["change"], kept), _leaf_norms(prog["change"], kept)
    c_med = statistics.median(c_ref.values())

    def gaps(a, b, med):
        return {n: abs(b[n] - a[n]) / max(a[n], med) for n in a}

    g_gap = gaps({n: g_ref[n] for n in kept}, g_prog, g_med)
    c_gap = gaps(c_ref, c_prog, c_med)
    g_leaf, c_leaf = max(g_gap, key=g_gap.get), max(c_gap, key=c_gap.get)
    ref_losses = group_losses(ref["losses"], prog["calls"])
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref_losses)]
    return {"loss": loss_gaps[0], "loss_2_3": loss_gaps[1],
            "grad": statistics.median(g_gap.values()),
            "change": statistics.median(c_gap.values()),
            "grad_worst": g_gap[g_leaf], "change_worst": c_gap[c_leaf],
            "grad_leaf": [g_leaf, g_ref[g_leaf], g_prog[g_leaf], g_med],
            "change_leaf": [c_leaf, c_ref[c_leaf], c_prog[c_leaf], c_med],
            "skipped_leaves": len(names) - len(kept),
            "ref_losses": ref_losses, "prog_losses": prog["losses"]}
