"""Multimodal posterior fusion: PoE and the MoPoE subset machinery.

Port of ``mopoe_mimic_tpu/ops/fusion.py``. Subset membership is a constant
``[S, M]`` 0/1 mask over the stacked ``[M, B, D]`` unimodal posteriors,
and every subset's product of experts is a statically unrolled masked
precision sum. ``poe_subsets`` here is the plain PyTorch version of the
subset-PoE kernel (``ops/cuda_fusion.py``): the path on the CPU and the
kernel's oracle on the GPU. Summation order matches the JAX function and
the Pallas kernel: prior first, then members in ascending index order.

What the JAX package fixes at trace time is built here once per key: the
mixture's row index on the device (``_selection_index``) and the range of
subsets that enter the joint (``passing_range``), so that a repeated call
copies nothing from the host.
"""

from __future__ import annotations

import functools
import itertools
import math
from types import MappingProxyType
from typing import Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

EPS = 1e-8

# M unimodal posteriors: stacked [M, B, D], or a sequence of M [B, D]
Experts = Union[torch.Tensor, Sequence[torch.Tensor]]


def subset_powerset(mod_names: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
    """Non-empty subsets of ``mod_names`` in the reference's dict order:
    by size, keys the sorted member names joined by '_', values the member
    indices into ``mod_names`` (fusion.py:38-55 of the JAX package)."""
    names = list(mod_names)
    out: Dict[str, Tuple[int, ...]] = {}
    combos = itertools.chain.from_iterable(
        itertools.combinations(names, n) for n in range(1, len(names) + 1)
    )
    for combo in combos:
        key = "_".join(sorted(combo))
        out[key] = tuple(names.index(m) for m in sorted(combo))
    return out


def subset_mask_matrix(mod_names: Sequence[str]) -> np.ndarray:
    """Constant [n_subsets, n_modalities] 0/1 membership mask, rows in
    ``subset_powerset`` order."""
    subsets = subset_powerset(mod_names)
    mask = np.zeros((len(subsets), len(mod_names)), dtype=np.float32)
    for row, members in enumerate(subsets.values()):
        mask[row, list(members)] = 1.0
    return mask


@functools.lru_cache(maxsize=64)
def subset_layout(mod_names: Tuple[str, ...]) -> Tuple[Mapping[str, Tuple[int, ...]], np.ndarray]:
    """``subset_powerset`` and ``subset_mask_matrix`` of ``mod_names``, built
    once per tuple of names and shared by every caller: a read-only mapping
    and a read-only array, so that no caller can change what the next one
    gets."""
    mask = subset_mask_matrix(mod_names)
    mask.setflags(write=False)
    return MappingProxyType(subset_powerset(mod_names)), mask


def subset_members(subset_mask: np.ndarray) -> List[Tuple[int, ...]]:
    """Member indices of each mask row, ascending."""
    mask = np.asarray(subset_mask) > 0.5
    return [tuple(int(m) for m in np.nonzero(row)[0]) for row in mask]


def passing_range(mod_names: Tuple[str, ...], method: str) -> Tuple[int, int]:
    """The subsets that enter the joint mixture (mmvae.py:214-220 of the JAX
    package), as rows [start, stop) of ``subset_layout(mod_names)``:
    moe/jsd the singletons, poe the full set, joint_elbo every subset. In
    ``subset_powerset`` order each is one contiguous range, which is
    checked here, once per (names, method)."""
    return _passing_range(tuple(mod_names), method)


@functools.lru_cache(maxsize=64)
def _passing_range(mod_names: Tuple[str, ...], method: str) -> Tuple[int, int]:
    sizes = [len(members) for members in subset_layout(mod_names)[0].values()]
    if method in ("moe", "jsd"):
        passing = [i for i, n in enumerate(sizes) if n == 1]
    elif method == "poe":
        passing = [i for i, n in enumerate(sizes) if n == len(mod_names)]
    elif method == "joint_elbo":
        passing = list(range(len(sizes)))
    else:
        raise ValueError(f"unknown method {method!r}")
    start, stop = passing[0], passing[-1] + 1
    if passing != list(range(start, stop)):
        raise ValueError(f"{method} over {mod_names}: passing subsets {passing} are not one range")
    return start, stop


def prior_precision(prior_expert: bool, eps: float = EPS) -> float:
    """Precision of the N(0, I) expert, 1/(exp(0) + eps), or 0 without it."""
    return 1.0 / (1.0 + eps) if prior_expert else 0.0


def poe(mus: torch.Tensor, logvars: torch.Tensor, eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precision-weighted Gaussian product over the leading (expert) axis."""
    t = 1.0 / (torch.exp(logvars) + eps)
    t_sum = t.sum(dim=0)
    pd_mu = (mus * t).sum(dim=0) / t_sum
    pd_var = 1.0 / t_sum
    return pd_mu, torch.log(pd_var)


def stacked(experts: Experts) -> torch.Tensor:
    """The experts as one [M, B, D] tensor: a stacked tensor as it is, a
    sequence of M [B, D] tensors stacked."""
    return experts if isinstance(experts, torch.Tensor) else torch.stack(list(experts))


def poe_subsets(
    mus: Experts,
    logvars: Experts,
    subset_mask: np.ndarray,
    prior_expert: bool = False,
    eps: float = EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All subset PoE products at once.

    mus, logvars: the unimodal posteriors, stacked [M, B, D] or as M
    tensors [B, D] (stacked here); subset_mask: [S, M] constant 0/1.
    ``prior_expert`` adds a N(0, I) expert to every product (method 'poe').
    Returns mu, logvar of shape [S, B, D].
    """
    mus, logvars = stacked(mus), stacked(logvars)
    t = 1.0 / (torch.exp(logvars) + eps)
    mu_t = mus * t
    prior_t = prior_precision(prior_expert, eps)
    t_rows, mu_rows = [], []
    for members in subset_members(subset_mask):
        t_sum = prior_t
        mu_t_sum = 0.0
        for m in members:
            t_sum = t_sum + t[m]
            mu_t_sum = mu_t_sum + mu_t[m]
        t_rows.append(t_sum)
        mu_rows.append(mu_t_sum)
    pd_var = 1.0 / torch.stack(t_rows)
    pd_mu = torch.stack(mu_rows) * pd_var
    return pd_mu, torch.log(pd_var)


def poe_subsets_bwd(
    mus: Experts,
    logvars: Experts,
    dmu_s: torch.Tensor,
    dlv_s: torch.Tensor,
    subset_mask: np.ndarray,
    prior_expert: bool = False,
    eps: float = EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form backward of ``poe_subsets``: the plain version of the
    CUDA backward kernel and its oracle.

    Recomputes T_m = 1/(exp(lv_m) + eps), T_S = prior_t + Σ_{m∈S} T_m and
    mu_S = (Σ mu_m·T_m)/T_S from the saved inputs, then accumulates over
    the subsets S that contain m (subsets in mask order):

        dmu_m = Σ_S (dmu_S/T_S)·T_m
        dT_m  = Σ_S (dmu_S/T_S)·(mu_m − mu_S) − dlv_S/T_S
        dlv_m = −dT_m·exp(lv_m)·T_m²

    mus, logvars: [M, B, D] or M tensors [B, D] (stacked here); dmu_s,
    dlv_s: [S, B, D]. Returns dmu, dlv of shape [M, B, D].
    """
    mus, logvars = stacked(mus), stacked(logvars)
    var = torch.exp(logvars)
    t = 1.0 / (var + eps)
    mu_t = mus * t
    prior_t = prior_precision(prior_expert, eps)
    dmu = [torch.zeros_like(mus[0]) for _ in range(mus.shape[0])]
    dt = [torch.zeros_like(mus[0]) for _ in range(mus.shape[0])]
    for s, members in enumerate(subset_members(subset_mask)):
        t_sum = prior_t
        mu_t_sum = 0.0
        for m in members:
            t_sum = t_sum + t[m]
            mu_t_sum = mu_t_sum + mu_t[m]
        inv = 1.0 / t_sum
        mu_s = mu_t_sum * inv
        g = dmu_s[s] * inv
        g_lv = dlv_s[s] * inv
        for m in members:
            dmu[m] = dmu[m] + g * t[m]
            dt[m] = dt[m] + (g * (mus[m] - mu_s) - g_lv)
    dmu_all = torch.stack(dmu)
    dlv_all = -torch.stack(dt) * var * (t * t)
    return dmu_all, dlv_all


def alpha_poe(alpha: torch.Tensor, mus: torch.Tensor, logvars: torch.Tensor,
              eps: float = EPS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted PoE with expert weights alpha [K] over the leading axis
    (the JSD objective's dynamic prior; fusion.py:128-138 of the JAX
    package)."""
    t = 1.0 / (torch.exp(logvars) + eps)
    alpha = alpha.reshape((-1,) + (1,) * (mus.dim() - 1)).to(mus.dtype)
    pd_var = 1.0 / torch.sum(alpha * t, dim=0)
    pd_mu = pd_var * torch.sum(alpha * mus * t, dim=0)
    return pd_mu, torch.log(pd_var)


def _partition_bounds(batch: int, weights: Sequence[float]) -> List[Tuple[int, int]]:
    """Component k owns batch rows [start_k, end_k) with end_k - start_k =
    floor(batch * w_k); the last component absorbs the remainder
    (mimic/utils/utils.py:55-77 of the reference)."""
    bounds: List[Tuple[int, int]] = []
    start = 0
    n = len(weights)
    for k, w in enumerate(weights):
        end = batch if k == n - 1 else start + int(math.floor(batch * float(w)))
        bounds.append((start, end))
        start = end
    return bounds


@functools.lru_cache(maxsize=64)
def _selection_index(batch: int, weights: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """The rows that ``mixture_component_selection`` takes from the
    flattened [K * B, D] inputs, c(b) * B + b for each row b: built once per
    (B, weights, device) and shared, as the JAX package's trace-time
    constant is. Built outside ``torch.inference_mode`` even when the first
    call runs in it: autograd cannot save an inference tensor."""
    rows = [k * batch + b for k, (s, e) in enumerate(_partition_bounds(batch, weights))
            for b in range(s, e)]
    with torch.inference_mode(False):
        return torch.tensor(rows, device=device)


def mixture_component_selection(
    mus: torch.Tensor,
    logvars: torch.Tensor,
    weights: Sequence[float],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic MoE 'sampling': row b of the [K, B, D] inputs comes
    from component c(b), a static stratified partition of the batch axis
    proportional to ``weights`` (``_partition_bounds``). The partition
    depends on B, so a padded batch selects differently from the unpadded
    one."""
    index = _selection_index(mus.shape[1], tuple(weights), mus.device)
    return mus.flatten(0, 1).index_select(0, index), logvars.flatten(0, 1).index_select(0, index)
