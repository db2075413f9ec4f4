"""The hand-written CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU: K1 (subset PoE) forward and backward, K2 (fused text head)
forward and backward.

Needs the card: marked ``cuda`` and skipped where CUDA is unavailable.
This file imports neither jax nor the JAX package, so it also runs where
they are absent; there, skip the repository's conftest (which loads jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: K1 forward 1e-6·max(1, |ref|) (the same operations in the
same order in float32, IEEE division, no fast-math; only exp/log rounding
may differ); K1 backward 1e-5·max(1, |ref|) (FMA contraction in the
kernel). K2 in float32 with TF32 off: lp rtol 1e-5 atol 1e-5, gradients
rtol 1e-4 atol 1e-5 (tests/test_pallas_texthead.py's bounds), against the
plain pair accumulated in float64; in bfloat16 against the plain pair fed
the same bfloat16 inputs: lp |Δ| ≤ 1e-3·max(1, |ref|), gradients
|Δ| ≤ 2e-2·max|ref|.
"""

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu_torch.ops import cuda_fusion, cuda_texthead
from mopoe_mimic_tpu_torch.ops import fusion as F
from mopoe_mimic_tpu_torch.ops import texthead as TH

pytestmark = pytest.mark.cuda

NAMES = ("PA", "Lateral", "text")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 128, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_matches_plain(device, m, b, prior):
    rng = np.random.default_rng(10 * m + b)
    mus, lvs = _normal(rng, (m, b, 64), device), _normal(rng, (m, b, 64), device)
    mask = F.subset_mask_matrix(NAMES[:m])
    k_mu, k_lv = cuda_fusion.poe_subsets_cuda(mus, lvs, mask, prior_expert=prior)
    r_mu, r_lv = F.poe_subsets(mus, lvs, mask, prior_expert=prior)
    torch.cuda.synchronize()
    for got, ref in ((k_mu, r_mu), (k_lv, r_lv)):
        bound = 1e-6 * torch.clamp(ref.abs(), min=1.0)
        assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_backward_kernel_matches_plain_and_autograd(device, m, b, prior):
    """Gradients through the autograd.Function (the backward kernel)
    against the closed form and against autograd of the plain forward."""
    rng = np.random.default_rng(100 + 10 * m + b)
    mask = F.subset_mask_matrix(NAMES[:m])
    mus, lvs = _normal(rng, (m, b, 64), device), _normal(rng, (m, b, 64), device)
    cot = (_normal(rng, (mask.shape[0], b, 64), device),
           _normal(rng, (mask.shape[0], b, 64), device))
    x = (mus.clone().requires_grad_(), lvs.clone().requires_grad_())
    before = dict(cuda_fusion.LAUNCHES)
    got = torch.autograd.grad(cuda_fusion.poe_subsets_cuda(*x, mask, prior_expert=prior), x, cot)
    assert cuda_fusion.LAUNCHES["poe_subsets_bwd_f32"] == before["poe_subsets_bwd_f32"] + 1
    y = (mus.clone().requires_grad_(), lvs.clone().requires_grad_())
    refs = (F.poe_subsets_bwd(mus, lvs, *cot, mask, prior_expert=prior),
            torch.autograd.grad(F.poe_subsets(*y, mask, prior_expert=prior), y, cot))
    torch.cuda.synchronize()
    for ref in refs:
        for g, r in zip(got, ref):
            bound = 1e-5 * torch.clamp(r.abs(), min=1.0)
            assert bool(((g - r).abs() <= bound).all()), float((g - r).abs().max())


def test_kernel_refuses_what_it_does_not_take(device):
    mask = F.subset_mask_matrix(NAMES)
    x = torch.zeros((3, 4, 8), device=device)
    with pytest.raises(TypeError):
        cuda_fusion.poe_subsets_cuda(x.double(), x.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fusion.poe_subsets_cuda(x.transpose(1, 2), x.transpose(1, 2), mask)


def _k2_case(device, B, L, C, V, dtype, seed):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, V, size=(B * L,))
    targets[0], targets[-1] = 0, V - 1
    return (torch.from_numpy(rng.normal(size=(B * L, C))).to(device, dtype),
            torch.from_numpy(rng.normal(size=(C, V)) * 0.1).to(device, dtype),
            torch.from_numpy(rng.normal(size=(V,)) * 0.1).to(device, torch.float32),
            torch.from_numpy(targets).to(device, torch.int32),
            torch.from_numpy(rng.normal(size=(B * L,))).to(device, torch.float32))


@pytest.mark.parametrize("shape", [(3, 17, 10, 37), (4, 128, 64, 3517), (2, 64, 128, 300),
                                   (256, 128, 64, 3517)])
def test_texthead_kernels_match_plain_f32(device, shape):
    h, k, b, t, g = _k2_case(device, *shape, torch.float32, seed=sum(shape))
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    dh = cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g)
    dw, db = cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g)
    r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t, torch.float64)
    refs = TH.texthead_bwd_plain(h, k, b, t, r_lse, g, torch.float64)
    torch.cuda.synchronize()
    for got, ref in ((lp, r_lp), (lse, r_lse)):
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    for got, ref in zip((dh, dw, db), refs):
        torch.testing.assert_close(got.double(), ref.double(), rtol=1e-4, atol=1e-5)


def test_texthead_kernels_match_plain_bf16(device):
    h, k, b, t, g = _k2_case(device, 256, 128, 64, 3517, torch.bfloat16, seed=9)
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    dh = cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g)
    dw, db = cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g)
    r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t)
    refs = TH.texthead_bwd_plain(h, k, b, t, r_lse, g)
    torch.cuda.synchronize()
    assert bool(((lp - r_lp).abs() <= 1e-3 * torch.clamp(r_lp.abs(), min=1.0)).all())
    for got, ref in zip((dh, dw, db), refs):
        err = (got.float() - ref.float()).abs().max()
        assert float(err) <= 2e-2 * float(ref.float().abs().max())


def test_fused_text_logprob_gradients_through_the_kernels(device):
    """fused_text_logprob on CUDA tensors launches the three kernels and its
    gradients equal autograd of the unfused reference."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(3, 32, 24)).astype(np.float32)).to(device)
    k = torch.from_numpy((rng.normal(size=(24, 301)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((rng.normal(size=(301,)) * 0.1).astype(np.float32)).to(device)
    t = torch.from_numpy(rng.integers(0, 301, (3, 32))).to(device)
    w = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(device)
    x = [a.clone().requires_grad_() for a in (h, k, b)]
    before = dict(cuda_texthead.LAUNCHES)
    got = torch.autograd.grad((w * TH.fused_text_logprob(*x, t)).sum(), x)
    assert all(cuda_texthead.LAUNCHES[n] == before[n] + 1 for n in before)
    y = [a.clone().requires_grad_() for a in (h, k, b)]
    ref = torch.autograd.grad((w * TH.reference_text_logprob(*y, t)).sum(), y)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_texthead_refuses_what_it_does_not_take(device):
    h, k, b, t, _ = _k2_case(device, 2, 8, 16, 40, torch.float32, seed=1)
    with pytest.raises(TypeError):
        cuda_texthead.texthead_cuda(h, k.to(torch.bfloat16), b, t)
    with pytest.raises(ValueError, match="channels"):
        wide = torch.zeros((16, 129), device=device)
        cuda_texthead.texthead_cuda(wide, torch.zeros((129, 40), device=device), b, t)
    with pytest.raises(ValueError, match="different devices"):
        TH.fused_text_logprob(h.reshape(2, 8, 16), k.cpu(), b, t.reshape(2, 8))
