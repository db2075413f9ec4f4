"""Train state: the model, its optimizer, the step count and the random
generator.

Port of ``mopoe_mimic_tpu/train/state.py``. The optimizer is
``torch.optim.Adam`` with the reference's hyperparameters
(experiment.py:171-178). Each parameter group carries ``base_lr``, the
learning rate the plateau callback reads and scales; the train step sets
the group's ``lr`` to ``base_lr`` times the warmup ramp before each update
(for Adam the same as optax's ramp on the update). Global-norm clipping
is the train step's too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Mapping, Optional, Union

import torch

from mopoe_mimic_tpu_torch.models.mmvae import MMVae


@dataclass
class TrainState:
    model: MMVae
    optimizer: torch.optim.Optimizer
    step: int
    generator: torch.Generator


def make_optimizer(cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
    opt = torch.optim.Adam(params, lr=cfg.initial_learning_rate,
                           betas=(cfg.beta_1, cfg.beta_2), eps=1e-8)
    for group in opt.param_groups:
        group["base_lr"] = cfg.initial_learning_rate
    return opt


def warmup_factor(cfg, step: int) -> float:
    """The ``lr_warmup_steps`` linear ramp 1/N → 1 (state.py:53-59)."""
    n = getattr(cfg, "lr_warmup_steps", 0)
    return min(1.0, (step + 1.0) / n) if n > 0 else 1.0


def create_train_state(cfg, device: Union[str, torch.device] = "cuda",
                       state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                       seed: int = 0) -> TrainState:
    """PyTorch's default init from ``seed`` (what the JAX package's
    ``torch_init=True`` emulates), or the given ``state_dict``; parameters
    in ``cfg.param_dtype`` (float32, or float64 for oracle runs), on
    ``device``: the card unless the caller asks for the CPU."""
    device = torch.device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MMVae(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(device=device, dtype=getattr(torch, cfg.param_dtype)).train()
    generator = torch.Generator(device=device).manual_seed(seed)
    return TrainState(model, make_optimizer(cfg, model.parameters()), 0, generator)


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["base_lr"])


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["base_lr"] = float(lr)
    return state
