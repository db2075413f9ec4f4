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
The plain ``poe_subsets`` and its backward take the experts as a stacked
[M, B, D] pair or as M [B, D] tensors, bitwise alike. The mixture's row
index is built once per (B, weights, device) and shared, as the JAX
package's trace-time constant is; the range of subsets that enter the
joint is held to the JAX package's list, and
``MMVae.inference`` under moe and jsd (joint_elbo and poe are held by
tests/test_torch_port_slice.py's encode) to the JAX model's, on carried-over
weights in eval mode: rtol 1e-4, atol 1e-5·max(1, max|ref|) as in
tests/test_torch_port_modules.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.ops import distributions as JD
from mopoe_mimic_tpu.ops import fusion as JF
from mopoe_mimic_tpu.ops import kl as JK
from mopoe_mimic_tpu.ops.pallas_fusion import poe_subsets_pallas
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.ops import distributions as TD
from mopoe_mimic_tpu_torch.ops import fusion as TF
from mopoe_mimic_tpu_torch.ops import kl as TK
from mopoe_mimic_tpu_torch.ops import cuda_fusion as CF
from mopoe_mimic_tpu_torch.ops.cuda_fusion import poe_subsets_cuda
from mopoe_mimic_tpu_torch.ops.sampling import reparameterize
from test_torch_port_modules import assert_close

NAMES = ("PA", "Lateral", "text")
D = 8


def _posteriors(m, b, seed):
    rng = np.random.default_rng(seed)
    mus = rng.normal(size=(m, b, D)).astype(np.float32)
    lvs = rng.normal(size=(m, b, D)).astype(np.float32)
    return mus, lvs


def _as_form(x, form):
    """Stacked [M, B, D] numpy experts as the plain function takes them."""
    t = torch.from_numpy(x)
    return t if form == "stacked" else list(t.unbind(0))


@pytest.mark.parametrize("form", ["stacked", "sequence"])
@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 8])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_poe_subsets_matches_jax(m, b, prior, form):
    mus, lvs = _posteriors(m, b, seed=100 * m + b)
    mask = TF.subset_mask_matrix(NAMES[:m])
    np.testing.assert_array_equal(mask, JF.subset_mask_matrix(NAMES[:m]))

    t_mu, t_lv = TF.poe_subsets(_as_form(mus, form), _as_form(lvs, form), mask,
                                prior_expert=prior)
    s_mu, s_lv = TF.poe_subsets(torch.from_numpy(mus), torch.from_numpy(lvs), mask,
                                prior_expert=prior)
    assert torch.equal(t_mu, s_mu) and torch.equal(t_lv, s_lv)  # the forms alike, bitwise
    refs = [JF.poe_subsets(jnp.asarray(mus), jnp.asarray(lvs), mask, prior_expert=prior)]
    if form == "stacked":  # the sequence form equals it bitwise: no second interpret run
        refs.append(poe_subsets_pallas(jnp.asarray(mus), jnp.asarray(lvs), mask,
                                       prior_expert=prior, interpret=True))
    assert t_mu.shape == (2 ** m - 1, b, D)
    for ref_mu, ref_lv in refs:
        np.testing.assert_allclose(t_mu.numpy(), np.asarray(ref_mu), rtol=0, atol=1e-6)
        np.testing.assert_allclose(t_lv.numpy(), np.asarray(ref_lv), rtol=0, atol=1e-6)


def test_poe_matches_jax():
    mus, lvs = _posteriors(3, 5, seed=7)
    t_mu, t_lv = TF.poe(torch.from_numpy(mus), torch.from_numpy(lvs))
    j_mu, j_lv = JF.poe(jnp.asarray(mus), jnp.asarray(lvs))
    np.testing.assert_allclose(t_mu.numpy(), np.asarray(j_mu), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t_lv.numpy(), np.asarray(j_lv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k,b", [(1, 4), (2, 5), (3, 8), (7, 4), (7, 9), (4, 128), (3, 1)])
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
    with pytest.raises(ValueError, match="not a CUDA device"):  # the experts as M tensors
        poe_subsets_cuda(list(torch.from_numpy(mus)), list(torch.from_numpy(lvs)),
                         TF.subset_mask_matrix(NAMES))
    with pytest.raises(TypeError, match="both"):
        poe_subsets_cuda(torch.from_numpy(mus), list(torch.from_numpy(lvs)),
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


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_kernel_layout_takes_the_power_set_kernels_only_for_the_power_set(m):
    """The power-set kernels (members compiled in) for the mask of
    ``subset_mask_matrix`` row for row at M <= 3; any other mask, and M = 4,
    the generic kernels with the member bitmasks."""
    names = ("PA", "Lateral", "text", "x")[:m]
    full = TF.subset_mask_matrix(names)
    layout = CF.kernel_layout(full, m)
    assert layout.n_subsets == 2 ** m - 1
    assert (layout.masks is None) == (m <= 3)
    assert CF.kernel_layout(np.array(full, copy=True), m) is layout  # cached by contents
    for other in _masks_of(m)[1:] if m <= 3 else []:
        if not np.array_equal(other, full):
            got = CF.kernel_layout(other, m)
            assert got.masks is CF.subset_masks(other, m) and got.n_subsets == other.shape[0]
    assert CF.powerset_members(3) == (0b001, 0b010, 0b100, 0b011, 0b101, 0b110, 0b111)


def test_experts_struct_holds_addresses_and_row_strides():
    """The kernels' ``Experts`` holds the M mu then M logvar addresses and
    row strides in place, zeros after."""
    e = CF._experts([16, 32, 48, 64, 80, 96], [64, 68, 72, 76, 80, 84])
    assert list(e.mu)[:3] == [16, 32, 48] and list(e.lv)[:3] == [64, 80, 96]
    assert not any(list(e.mu)[3:]) and not any(list(e.lv)[3:])
    assert list(e.mu_row) == [64, 68, 72, 0, 0, 0, 0, 0]
    assert list(e.lv_row) == [76, 80, 84, 0, 0, 0, 0, 0]


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


@pytest.mark.parametrize("form", ["stacked", "sequence"])
@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_poe_subsets_gradients_match_jax_vjp(m, prior, form):
    """K1's backward: the port's autograd through the plain forward and the
    closed form ``poe_subsets_bwd`` against jax.vjp of the Pallas kernel
    (experts stacked) or of the JAX function (experts as M tensors, whose
    closed-form gradients equal the stacked ones bitwise)."""
    mus, lvs = _posteriors(m, 5, seed=10 * m + prior)
    mask = TF.subset_mask_matrix(NAMES[:m])
    rng = np.random.default_rng(m)
    dmu_s = rng.normal(size=(mask.shape[0], 5, D)).astype(np.float32)
    dlv_s = rng.normal(size=(mask.shape[0], 5, D)).astype(np.float32)
    if form == "stacked":  # the Pallas kernel; the sequence form against the JAX function
        fn = lambda a, b: poe_subsets_pallas(a, b, mask, prior_expert=prior,  # noqa: E731
                                             interpret=True)
    else:
        fn = lambda a, b: JF.poe_subsets(a, b, mask, prior_expert=prior)  # noqa: E731
    _, vjp = jax.vjp(fn, jnp.asarray(mus), jnp.asarray(lvs))
    ref = vjp((jnp.asarray(dmu_s), jnp.asarray(dlv_s)))

    up = (torch.from_numpy(dmu_s), torch.from_numpy(dlv_s))
    if form == "stacked":
        x = (torch.from_numpy(mus).requires_grad_(), torch.from_numpy(lvs).requires_grad_())
        auto = torch.autograd.grad(TF.poe_subsets(*x, mask, prior_expert=prior), x, up)
    else:
        xs = [t.clone().requires_grad_() for t in (*torch.from_numpy(mus), *torch.from_numpy(lvs))]
        grads = torch.autograd.grad(TF.poe_subsets(xs[:m], xs[m:], mask, prior_expert=prior),
                                    xs, up)
        auto = (torch.stack(grads[:m]), torch.stack(grads[m:]))
    closed = TF.poe_subsets_bwd(_as_form(mus, form), _as_form(lvs, form), *up, mask,
                                prior_expert=prior)
    stacked = TF.poe_subsets_bwd(torch.from_numpy(mus), torch.from_numpy(lvs), *up, mask,
                                 prior_expert=prior)
    assert all(torch.equal(a, b) for a, b in zip(closed, stacked))
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


def _jax_passing(names, method):
    """The JAX package's passing subsets, as MMVae.inference lists them
    (mopoe_mimic_tpu/models/mmvae.py:214-220)."""
    subsets = JF.subset_powerset(names)
    if method in ("moe", "jsd"):
        return [i for i, ms in enumerate(subsets.values()) if len(ms) == 1]
    if method == "poe":
        return [i for i, ms in enumerate(subsets.values()) if len(ms) == len(names)]
    return list(range(len(subsets)))


@pytest.mark.parametrize("method", ["joint_elbo", "poe", "moe", "jsd"])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_passing_range_is_the_jax_list(m, method):
    start, stop = TF.passing_range(NAMES[:m], method)
    assert list(range(start, stop)) == _jax_passing(NAMES[:m], method)
    assert TF.passing_range(NAMES[:m], method) == (start, stop)


@pytest.mark.parametrize("k,b", [(2, 5), (3, 8), (4, 3)])
def test_mixture_selection_takes_each_component_s_rows(k, b):
    """Row b comes from its component's rows [start_k, end_k) of
    ``_partition_bounds``: each row's gradient reaches its own component
    only, and an empty share (B < K) takes nothing."""
    x = torch.arange(k, dtype=torch.float32)[:, None, None].expand(k, b, 2).clone()
    x.requires_grad_()
    mu, lv = TF.mixture_component_selection(x, x, [1.0 / k] * k)
    bounds = TF._partition_bounds(b, [1.0 / k] * k)
    want = [float(c) for c, (s, e) in enumerate(bounds) for _ in range(s, e)]
    assert mu[:, 0].tolist() == want and torch.equal(mu, lv)
    (mu.sum() + lv.sum()).backward()
    for c, (s, e) in enumerate(bounds):
        rows = torch.zeros(b)
        rows[s:e] = 2.0  # mu and lv each take the row once
        assert torch.equal(x.grad[c, :, 0], rows)


@pytest.mark.parametrize("k", [2, 7])
def test_mixture_selection_backward_is_one_scatter(k):
    """The selection's backward is one zero fill and one index_add,
    whatever K: slices joined by ``cat`` would cost a fill and a copy for
    each slice and each select, and an add for each component."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aliases = {"view", "_unsafe_view", "reshape", "alias", "detach", "as_strided", "expand"}

    class Ops(TorchDispatchMode):  # the ops that launch a kernel
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.__name__.split(".")[0]
            if name not in aliases:
                self.names.append(name)
            return func(*args, **(kwargs or {}))

    x = torch.randn(k, 8, D, requires_grad=True)
    mu, _ = TF.mixture_component_selection(x, x, [1.0 / k] * k)
    grad = torch.ones_like(mu)
    with Ops() as ops:
        mu.backward(grad)
    assert sorted(ops.names) == ["index_add", "new_zeros"], ops.names


def test_mixture_selection_index_is_built_once_and_shared():
    """One index per (B, weights, device), the same tensor on a repeated
    call; a normal tensor when first built under ``inference_mode``, so a
    later call can record gradients through it."""
    TF._selection_index.cache_clear()
    x = torch.randn(3, 8, D)
    w = [1.0 / 3] * 3
    with torch.inference_mode():
        TF.mixture_component_selection(x, x, w)
    index = TF._selection_index(8, tuple(w), torch.device("cpu"))
    assert not index.is_inference() and index.dtype == torch.int64
    y = x.clone().requires_grad_()
    TF.mixture_component_selection(y, y, tuple(w))[0].sum().backward()
    assert TF._selection_index(8, tuple(w), torch.device("cpu")) is index
    assert TF._selection_index.cache_info().currsize == 1
    TF.mixture_component_selection(x[:2, :5], x[:2, :5], [0.5, 0.5])
    assert TF._selection_index.cache_info().currsize == 2  # another (B, weights)
    TF._selection_index.cache_clear()


KW = dict(dataset="testing", batch_size=4, class_dim=4, DIM_img=4, DIM_text=4, img_size=64,
          text_encoding="word", vocab_size=30, compute_dtype="float32")


@pytest.mark.parametrize("method", ["moe", "jsd"])
def test_inference_matches_jax(method):
    """MMVae.inference in eval mode against the JAX model's on the port's
    seeded weights: every subset, the joint's components and the joint."""
    rng = np.random.default_rng(6)
    batch = {"PA": rng.random((4, 64, 64, 1), dtype=np.float32),
             "Lateral": rng.random((4, 64, 64, 1), dtype=np.float32),
             "text": rng.integers(0, 30, (4, 128)).astype(np.int32)}
    torch.manual_seed(0)
    model = MMVae(MopoeConfig(method=method, **KW)).eval()
    jcfg = JaxConfig(method=method, **KW)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in model.state_dict().items()}, jcfg)
    ref = jax_mmvae.MMVae(jcfg).apply(
        {"params": conv["params"], "batch_stats": conv["batch_stats"]},
        {k: jnp.asarray(v) for k, v in batch.items()}, train=False,
        method=jax_mmvae.MMVae.inference)
    with torch.no_grad():
        got = model.inference({k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy()
                                                   if v.ndim == 4 else v)
                               for k, v in batch.items()})
    assert list(got["subsets"]) == list(ref["subsets"])
    for key, pair in ref["subsets"].items():
        for g, r in zip(got["subsets"][key], pair):
            assert_close(g.numpy(), np.asarray(r))
    for name in ("mus", "logvars"):
        assert_close(got[name].numpy(), np.asarray(ref[name]))
    for g, r in zip(got["joint"], ref["joint"]):
        assert_close(g.numpy(), np.asarray(r))


def test_chip_smoke_k1_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's K1 phase (every case and its checks, the backward
    under a saved-tensor hook, the device times, the times and the kernels
    line's entries) with the plain versions standing in for the kernels,
    on the CPU."""
    import chip_smoke

    cf = chip_smoke.cuda_fusion
    monkeypatch.setattr(cf, "poe_subsets_cuda", lambda mus, lvs, mask, prior_expert=False:
                        TF.poe_subsets(mus, lvs, mask, prior_expert=prior_expert))
    monkeypatch.setattr(cf, "poe_subsets_bwd_cuda", lambda mus, lvs, dmu, dlv, mask,
                        prior_expert=False: TF.poe_subsets_bwd(mus, lvs, dmu, dlv, mask,
                                                               prior_expert=prior_expert))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, calls=1, warmup=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_us_by_kernel",
                        lambda fn, calls=5, expect=(): (fn(), dict.fromkeys(expect, 2.0))[1])
    monkeypatch.setattr(chip_smoke, "k1_host_us", lambda device: {"poe_subsets_cuda": 1.0})
    # small B keep the rehearsal to a few seconds
    monkeypatch.setattr(chip_smoke, "K1_BATCHES", (1, 5))
    out = chip_smoke.k1_entries(torch.device("cpu"), "card")
    keys = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert set(out) == set(chip_smoke.K1_GLOBALS) and all(keys <= set(v) for v in out.values())
    fwd, bwd = out["poe_subsets_f32"], out["poe_subsets_bwd_f32"]
    assert fwd["max_abs_err"] <= 1e-6 and bwd["max_abs_err"] <= 1e-5
    # B = 256, M = 3, D = 64: the forward reads 2M and writes 2S floats an
    # element, the backward reads 2M + 2S and writes 2M
    assert fwd["bound_ms"] == pytest.approx(20 * 256 * 64 * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert bwd["bound_ms"] == pytest.approx(26 * 256 * 64 * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert fwd["bound_by"] == bwd["bound_by"] == "bytes" and fwd["library_ms"] is None
    assert fwd["device_us"] == bwd["device_us"] == {8: 2.0, 128: 2.0, 256: 2.0}
    assert fwd["host_us"] == {"poe_subsets_cuda": 1.0}


def test_chip_smoke_names_where_a_step_synchronizes(monkeypatch):
    """chip_smoke.py's phase-7 sync report: each synchronizing operation is
    put at the innermost frame of the port on the stack, and one in the
    latent block fails the check (sync debug mode's warnings stood in for)."""
    import warnings

    import chip_smoke

    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def synchronizing_stack(tensors):
        warnings.warn("called a synchronizing CUDA operation")
        return tensors[0][None]

    def step(state, batch):
        warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("an unrelated warning")
        return state

    sites = chip_smoke.check_latent_block_syncs({"step": step, "state": 0, "batch": None})
    assert list(sites.values()) == [1]
    assert next(iter(sites)).startswith("tests/test_torch_port_fusion.py:")
    monkeypatch.setattr(torch, "stack", synchronizing_stack)
    latent = {"step": lambda state, batch: TF.stacked([torch.zeros(2)]), "state": 0,
              "batch": None}
    with pytest.raises(chip_smoke.SmokeFailure, match="mopoe_mimic_tpu_torch/ops/fusion.py"):
        chip_smoke.check_latent_block_syncs(latent)


def test_chip_smoke_reads_k1_registers_and_refuses_a_spill():
    """chip_smoke.py's phase 2 for K1 on a ptxas report: every power-set
    instantiation (M ≤ 3, prior both ways) and the generic
    kernels are there, and a spill fails the check, naming the kernel."""
    import chip_smoke

    clean = {"registers": 40, "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0}
    report = {f"_Z{n}{g}ILi{m}ELb{p}EEv7Experts": dict(clean)
              for n, g in ((22, "poe_subsets_f32_kernel"), (26, "poe_subsets_bwd_f32_kernel"))
              for m in (1, 2, 3) for p in (0, 1)}
    report.update({"_Z30poe_subsets_generic_f32_kernel7Experts": dict(clean),
                   "_Z34poe_subsets_generic_bwd_f32_kernel7Experts": dict(clean),
                   "_Z15texthead_fwd_tcILi4ELi16EEv": dict(clean)})
    assert len(chip_smoke.k1_resources(report)) == 14
    report["_Z22poe_subsets_f32_kernelILi3ELb0EEv7Experts"]["spill_store_bytes"] = 8
    with pytest.raises(chip_smoke.SmokeFailure, match="ILi3ELb0EEv7Experts: spills"):
        chip_smoke.k1_resources(report)
    del report["_Z30poe_subsets_generic_f32_kernel7Experts"]
    with pytest.raises(chip_smoke.SmokeFailure, match="instantiations"):
        chip_smoke.k1_resources(report)
