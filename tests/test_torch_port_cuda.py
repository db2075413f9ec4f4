"""K1, the hand-written CUDA subset-PoE kernel, against its plain PyTorch
version on an NVIDIA GPU.

Needs the card: marked ``cuda`` and skipped where CUDA is unavailable.
This file imports neither jax nor the JAX package, so it also runs where
they are absent; there, skip the repository's conftest (which loads jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance 1e-6·max(1, |ref|): the same operations in the same order in
float32, IEEE division, no fast-math; only exp/log rounding may differ.
"""

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu_torch.ops import cuda_fusion
from mopoe_mimic_tpu_torch.ops import fusion as F

pytestmark = pytest.mark.cuda

NAMES = ("PA", "Lateral", "text")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 128, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_matches_plain(device, m, b, prior):
    rng = np.random.default_rng(10 * m + b)
    mus = torch.from_numpy(rng.normal(size=(m, b, 64)).astype(np.float32)).to(device)
    lvs = torch.from_numpy(rng.normal(size=(m, b, 64)).astype(np.float32)).to(device)
    mask = F.subset_mask_matrix(NAMES[:m])
    k_mu, k_lv = cuda_fusion.poe_subsets_cuda(mus, lvs, mask, prior_expert=prior)
    r_mu, r_lv = F.poe_subsets(mus, lvs, mask, prior_expert=prior)
    torch.cuda.synchronize()
    for got, ref in ((k_mu, r_mu), (k_lv, r_lv)):
        bound = 1e-6 * torch.clamp(ref.abs(), min=1.0)
        assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


def test_kernel_refuses_what_it_does_not_take(device):
    mask = F.subset_mask_matrix(NAMES)
    x = torch.zeros((3, 4, 8), device=device)
    with pytest.raises(TypeError):
        cuda_fusion.poe_subsets_cuda(x.double(), x.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fusion.poe_subsets_cuda(x.transpose(1, 2), x.transpose(1, 2), mask)
    with pytest.raises(ValueError, match="grad"):
        cuda_fusion.poe_subsets_cuda(x.requires_grad_(), x, mask)
