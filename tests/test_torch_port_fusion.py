"""The port's fusion ops (mopoe_mimic_tpu_torch/ops) against the JAX package.

Same numpy inputs through both frameworks, float32 on the CPU. The port's
plain ``poe_subsets`` is the oracle of the CUDA kernel K1, so it is held
against the Pallas kernel (interpret mode, as tests/test_pallas_fusion.py
runs it) and the JAX plain version. Tolerance 1e-6 absolute: the same
operations in the same order, so only exp/log rounding may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.ops import fusion as JF
from mopoe_mimic_tpu.ops.pallas_fusion import poe_subsets_pallas
from mopoe_mimic_tpu_torch.ops import fusion as TF
from mopoe_mimic_tpu_torch.ops.cuda_fusion import poe_subsets_cuda
from mopoe_mimic_tpu_torch.ops.sampling import reparameterize

NAMES = ("PA", "Lateral", "text")
D = 8


def _posteriors(m, b, seed):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(m, b, D)).astype(np.float32)
    lvs = rng.normal(size=(m, b, D)).astype(np.float32)
    return mus, lvs


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_poe_subsets_matches_jax(m, b, prior):
    mus, lvs = _posteriors(m, b, seed=100 * m + b)
    mask = TF.subset_mask_matrix(NAMES[:m])
    np.testing.assert_array_equal(mask, JF.subset_mask_matrix(NAMES[:m]))

    t_mu, t_lv = TF.poe_subsets(torch.from_numpy(mus), torch.from_numpy(lvs), mask,
                                prior_expert=prior)
    p_mu, p_lv = poe_subsets_pallas(jnp.asarray(mus), jnp.asarray(lvs), mask,
                                    prior_expert=prior, interpret=True)
    j_mu, j_lv = JF.poe_subsets(jnp.asarray(mus), jnp.asarray(lvs), mask, prior_expert=prior)
    assert t_mu.shape == (2 ** m - 1, b, D)
    for ref_mu, ref_lv in ((p_mu, p_lv), (j_mu, j_lv)):
        np.testing.assert_allclose(t_mu.numpy(), np.asarray(ref_mu), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_lv.numpy(), np.asarray(ref_lv), rtol=0, atol=1e-6)


def test_poe_matches_jax():
    mus, lvs = _posteriors(3, 5, seed=7)
    t_mu, t_lv = TF.poe(torch.from_numpy(mus), torch.from_numpy(lvs))
    j_mu, j_lv = JF.poe(jnp.asarray(mus), jnp.asarray(lvs))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lv.numpy(), np.asarray(j_lv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,b", [(1, 4), (2, 5), (3, 8), (7, 4), (7, 9), (4, 128)])
def test_mixture_component_selection_matches_jax(k, b):
    rng = np.random.default_rng(k * 1000 + b)
    mus = rng.normal(size=(k, b, D)).astype(np.float32)
    lvs = rng.normal(size=(k, b, D)).astype(np.float32)
    w = [1.0 / k] * k
    assert TF._partition_bounds(b, w) == JF._partition_bounds(b, w)
    t_mu, t_lv = TF.mixture_component_selection(torch.from_numpy(mus), torch.from_numpy(lvs), w)
    j_mu, j_lv = JF.mixture_component_selection(jnp.asarray(mus), jnp.asarray(lvs), w)
    np.testing.assert_array_equal(t_mu.numpy(), np.asarray(j_mu))
    np.testing.assert_array_equal(t_lv.numpy(), np.asarray(j_lv))


@pytest.mark.parametrize("names", [NAMES[:1], NAMES[:2], NAMES, ("text",), ("a", "b", "c", "d")])
def test_subset_powerset_order_matches_jax(names):
    assert list(TF.subset_powerset(names).items()) == list(JF.subset_powerset(names).items())


def test_reparameterize_injected_eps_and_generator():
    rng = np.random.default_rng(3)
    mu = torch.from_numpy(rng.normal(size=(4, D)).astype(np.float32))
    lv = torch.from_numpy(rng.normal(size=(4, D)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(4, D)).astype(np.float32))
    torch.testing.assert_close(reparameterize(mu, lv, eps=eps), mu + eps * torch.exp(0.5 * lv))
    assert torch.equal(reparameterize(mu, lv, eps=0.0), mu)
    draw = lambda seed: reparameterize(mu, lv, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))


def test_poe_subsets_cuda_refuses_cpu_tensors():
    mus, lvs = _posteriors(3, 4, seed=0)
    with pytest.raises(ValueError, match="not a CUDA device"):
        poe_subsets_cuda(torch.from_numpy(mus), torch.from_numpy(lvs),
                         TF.subset_mask_matrix(NAMES))
