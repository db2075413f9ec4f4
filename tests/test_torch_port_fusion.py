"""The port's latent-space ops (mopoe_mimic_tpu_torch/ops: fusion, kl,
distributions) against the JAX package.

Same numpy inputs through both frameworks, float32 on the CPU. The port's
plain ``poe_subsets`` is the oracle of the CUDA kernel K1, so it is held
against the Pallas kernel (interpret mode, as tests/test_pallas_fusion.py
runs it) and the JAX plain version. Tolerance 1e-6 absolute: the same
operations in the same order, so only exp/log rounding may differ.
Gradients (K1's backward: autograd of the plain forward and the closed
form ``poe_subsets_bwd`` that the CUDA backward computes) are held against
``jax.vjp`` of the Pallas kernel at 1e-5·max(1, |ref|): another order of
operations. KL divergences and log-probabilities: rtol 1e-5. K1's host-side
caches (the kernel's member bitmasks per mask, the power set and mask per
tuple of modalities) are held to fresh constructions, and shown read-only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.ops import distributions as JD
from mopoe_mimic_tpu.ops import fusion as JF
from mopoe_mimic_tpu.ops import kl as JK
from mopoe_mimic_tpu.ops.pallas_fusion import poe_subsets_pallas
from mopoe_mimic_tpu_torch.ops import distributions as TD
from mopoe_mimic_tpu_torch.ops import fusion as TF
from mopoe_mimic_tpu_torch.ops import kl as TK
from mopoe_mimic_tpu_torch.ops import cuda_fusion as CF
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


def _masks_of(m):
    """Every subset mask of m modalities the tests feed K1: the power set,
    each of its rows alone, and its rows in reverse order."""
    full = TF.subset_mask_matrix(NAMES[:m])
    return [full, full[::-1]] + [full[i:i + 1] for i in range(full.shape[0])]


@pytest.mark.parametrize("m", [1, 2, 3])
def test_cached_subset_masks_equal_a_fresh_construction(m):
    for mask in _masks_of(m):
        cached, fresh = CF.subset_masks(mask, m), CF._masks(mask, m)
        assert cached.n_subsets == fresh.n_subsets == mask.shape[0]
        assert list(cached.members) == list(fresh.members)
        assert CF.subset_masks(mask, m) is cached  # built once


def test_subset_masks_share_an_entry_for_equal_contents():
    a = TF.subset_mask_matrix(NAMES)
    b = np.array(a, copy=True)  # another array, the same contents
    assert b is not a and CF.subset_masks(a, 3) is CF.subset_masks(b, 3)
    assert CF.subset_masks(a, 3) is CF.subset_masks(TF.subset_layout(NAMES)[1], 3)
    other = a[::-1]  # the same rows in another order: other contents
    assert CF.subset_masks(other, 3) is not CF.subset_masks(a, 3)
    assert list(CF.subset_masks(other, 3).members)[:7] == list(CF._masks(a, 3).members)[:7][::-1]
    b[0, 1] = 1.0  # a mask changed after its first use gets its own entry
    assert CF.subset_masks(b, 3) is not CF.subset_masks(a, 3)
    assert CF.subset_masks(b, 3).members[0] == 0b011


def test_subset_masks_refuse_on_every_call():
    """Nothing is cached for a mask that the kernel does not take."""
    for _ in range(2):
        with pytest.raises(ValueError, match="columns"):
            CF.subset_masks(TF.subset_mask_matrix(NAMES[:2]), 3)
        with pytest.raises(ValueError, match="subsets"):
            CF.subset_masks(np.ones((256, 2), np.float32), 2)


@pytest.mark.parametrize("names", [NAMES[:1], NAMES[:2], NAMES, ("text", "PA")])
def test_subset_layout_is_cached_and_read_only(names):
    subsets, mask = TF.subset_layout(names)
    assert TF.subset_layout(tuple(names)) == (subsets, mask)
    assert TF.subset_layout(tuple(names))[1] is mask
    assert dict(subsets) == TF.subset_powerset(names)
    np.testing.assert_array_equal(mask, TF.subset_mask_matrix(names))
    assert not mask.flags.writeable
    with pytest.raises(ValueError):
        mask[0, 0] = 0.0
    with pytest.raises(TypeError):
        subsets["x"] = (0,)
    with pytest.raises(TypeError):
        del subsets[next(iter(subsets))]
    assert TF.subset_layout(tuple(names))[0] == TF.subset_powerset(names)


def test_poe_subsets_cuda_refuses_cpu_tensors_with_a_warm_cache():
    mask = TF.subset_layout(NAMES)[1]
    CF.subset_masks(mask, 3)
    mus, lvs = _posteriors(3, 4, seed=1)
    for x in (torch.from_numpy(mus), torch.from_numpy(mus).requires_grad_()):
        with pytest.raises(ValueError, match="not a CUDA device"):
            poe_subsets_cuda(x, torch.from_numpy(lvs), mask)


def _close_grad(got, ref):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref)
    assert (err <= 1e-5 * np.maximum(1.0, np.abs(ref))).all(), float(err.max())


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_poe_subsets_gradients_match_jax_vjp(m, prior):
    """K1's backward: the port's autograd through the plain forward and the
    closed form ``poe_subsets_bwd`` against jax.vjp of the Pallas kernel."""
    mus, lvs = _posteriors(m, 5, seed=10 * m + prior)
    mask = TF.subset_mask_matrix(NAMES[:m])
    rng = np.random.default_rng(m)
    dmu_s = rng.normal(size=(mask.shape[0], 5, D)).astype(np.float32)
    dlv_s = rng.normal(size=(mask.shape[0], 5, D)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: poe_subsets_pallas(a, b, mask, prior_expert=prior,
                                                     interpret=True),
                     jnp.asarray(mus), jnp.asarray(lvs))
    ref = vjp((jnp.asarray(dmu_s), jnp.asarray(dlv_s)))

    x = (torch.from_numpy(mus).requires_grad_(), torch.from_numpy(lvs).requires_grad_())
    out = TF.poe_subsets(*x, mask, prior_expert=prior)
    auto = torch.autograd.grad(out, x, (torch.from_numpy(dmu_s), torch.from_numpy(dlv_s)))
    closed = TF.poe_subsets_bwd(torch.from_numpy(mus), torch.from_numpy(lvs),
                                torch.from_numpy(dmu_s), torch.from_numpy(dlv_s), mask,
                                prior_expert=prior)
    for got in (auto, closed):
        for g, r in zip(got, ref):
            _close_grad(g.numpy(), r)
    for g, r in zip(closed, auto):  # the CUDA backward's oracle against autograd
        _close_grad(g.numpy(), r.numpy())


def test_alpha_poe_matches_jax():
    mus, lvs = _posteriors(4, 5, seed=11)
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    got = TF.alpha_poe(torch.from_numpy(w), torch.from_numpy(mus), torch.from_numpy(lvs))
    ref = JF.alpha_poe(jnp.asarray(w), jnp.asarray(mus), jnp.asarray(lvs))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("target", ["prior", "other"])
def test_kl_divergences_match_jax(target):
    mu0, lv0 = _posteriors(3, 5, seed=12)
    mu1, lv1 = _posteriors(3, 5, seed=13) if target == "other" else (None, None)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    pairs = [
        (TK.kl_divergence(t(mu0), t(lv0), t(mu1), t(lv1), norm_value=4),
         JK.kl_divergence(j(mu0), j(lv0), j(mu1), j(lv1), norm_value=4)),
        (TK.kl_divergence_batched(t(mu0), t(lv0), t(mu1), t(lv1), norm_value=4),
         JK.kl_divergence_batched(j(mu0), j(lv0), j(mu1), j(lv1), norm_value=4)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_joint_divergences_match_jax():
    mus, lvs = _posteriors(4, 6, seed=14)
    w = np.full((4,), 0.25, np.float32)
    args_t = (torch.from_numpy(mus), torch.from_numpy(lvs), torch.from_numpy(w))
    args_j = (jnp.asarray(mus), jnp.asarray(lvs), jnp.asarray(w))
    got, ref = TK.group_divergence_moe(*args_t, 6), JK.group_divergence_moe(*args_j, 6)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)
    got, ref = TK.alpha_jsd_divergence(*args_t, 6), JK.alpha_jsd_divergence(*args_j, 6)
    for g, r in zip(got[:2] + got[2], ref[:2] + ref[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["laplace", "normal", "bernoulli", "categorical"])
def test_log_probs_match_jax(name):
    rng = np.random.default_rng(15)
    x = rng.random((4, 6, 5)).astype(np.float32)
    loc = rng.random((4, 6, 5)).astype(np.float32)
    if name == "laplace":
        got, ref = TD.laplace_log_prob(torch.from_numpy(x), torch.from_numpy(loc), 0.75), \
            JD.laplace_log_prob(jnp.asarray(x), jnp.asarray(loc), 0.75)
    elif name == "normal":
        got, ref = TD.normal_log_prob(torch.from_numpy(x), torch.from_numpy(loc), 0.75), \
            JD.normal_log_prob(jnp.asarray(x), jnp.asarray(loc), 0.75)
    elif name == "bernoulli":
        xb = (x > 0.5).astype(np.float32)
        got, ref = TD.bernoulli_log_prob(torch.from_numpy(xb), torch.from_numpy(loc)), \
            JD.bernoulli_log_prob(jnp.asarray(xb), jnp.asarray(loc))
    else:
        onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (4, 6))]
        logits = rng.normal(size=(4, 6, 5)).astype(np.float32)
        got, ref = TD.one_hot_categorical_log_prob(torch.from_numpy(onehot),
                                                   torch.from_numpy(logits)), \
            JD.one_hot_categorical_log_prob(jnp.asarray(onehot), jnp.asarray(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
