"""Train state: the model, its optimizer, the step count and the random
generator.

Port of ``mopoe_mimic_tpu/train/state.py``. The optimizer is
``torch.optim.Adam`` with the reference's hyperparameters
(experiment.py:171-178), capturable, so that a CUDA graph can hold its
update (``train/scan.py``), and fused. Its learning rate lives
on the parameters' device: each group's ``base_lr`` (the rate the plateau
callback reads and scales) and ``lr`` are one-element tensors, and the
train step writes ``lr = base_lr × warmup ramp`` on the device from the
device step count ``step_t`` (for Adam the same as optax's ramp on the
update). ``TrainState.step`` is the host's copy of the count, advanced by
the steps run, read without waiting for the card. Global-norm clipping is
the train step's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Union

import torch

from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.utils import profiling


@dataclass
class TrainState:
    model: MMVae
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator
    step_t: torch.Tensor  # the step count on the parameters' device (float32)


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                   device: Union[str, torch.device]) -> torch.optim.Adam:
    device = torch.device(device)
    lr = torch.tensor(cfg.initial_learning_rate, dtype=torch.float32, device=device)
    # fused: one kernel per dtype for every tensor's update, on the card and
    # on the CPU (where a capturable Adam is only the fused one)
    opt = torch.optim.Adam(params, lr=lr, betas=(cfg.beta_1, cfg.beta_2), eps=1e-8,
                           capturable=True, fused=True)
    for group in opt.param_groups:
        group["base_lr"] = lr.clone()
    return opt


def warmup_factor(cfg, step: int) -> float:
    """The ``lr_warmup_steps`` linear ramp 1/N → 1 (state.py:53-59)."""
    n = getattr(cfg, "lr_warmup_steps", 0)
    return min(1.0, (step + 1.0) / n) if n > 0 else 1.0


def set_step_learning_rate(cfg, state: "TrainState") -> None:
    """``lr = base_lr × warmup_factor(step_t)`` in every group, on the
    device, in place (nothing waits for the host; a CUDA graph replays it)."""
    n = getattr(cfg, "lr_warmup_steps", 0)
    for group in state.optimizer.param_groups:
        if n > 0:
            ramp = torch.clamp((state.step_t + 1.0) / n, max=1.0)
            torch.mul(group["base_lr"], ramp, out=group["lr"])
        else:
            group["lr"].copy_(group["base_lr"])


def create_train_state(cfg, device: Union[str, torch.device] = "cuda",
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       seed: int = 0) -> TrainState:
    """PyTorch's default init from ``seed`` (what the JAX package's
    ``torch_init=True`` emulates), or the given ``state_dict``; parameters
    in ``cfg.param_dtype`` (float32, or float64 for oracle runs), on
    ``device``: the card unless the caller asks for the CPU. The span
    ``state.init`` times it, ``state.model`` and ``state.optimizer`` its
    parts."""
    device = torch.device(device)
    with profiling.span("state.init"):
        with profiling.span("state.model"):
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = MMVae(cfg)
            if state_dict is not None:
                model.load_state_dict(state_dict)
            model.to(device=device, dtype=getattr(torch, cfg.param_dtype)).train()
        generator = torch.Generator(device=device).manual_seed(seed)
        with profiling.span("state.optimizer"):
            optimizer = make_optimizer(cfg, model.parameters(), device)
        return TrainState(model, optimizer, 0, generator,
                          torch.zeros((), dtype=torch.float32, device=device))


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["base_lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set every group's ``base_lr`` in place: a captured train step reads
    it at its next replay."""
    for group in state.optimizer.param_groups:
        group["base_lr"].fill_(float(lr))
    return state
