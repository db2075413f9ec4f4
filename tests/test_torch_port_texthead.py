"""The port's fused text vocab head (mopoe_mimic_tpu_torch/ops/texthead.py)
against the JAX package's (ops/pallas_texthead.py), float32 on the CPU.

The port's plain forward/backward pair is the oracle of the CUDA kernels
K2, so it is held against the Pallas kernels in interpret mode (as
tests/test_pallas_texthead.py runs them), on that file's shapes and
tolerances: values rtol 1e-5 and atol 1e-5, gradients rtol 1e-4 and atol
1e-5. The explicit backward is also held against torch.autograd of the
unfused reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.ops.pallas_texthead import fused_text_logprob as jax_fused
from mopoe_mimic_tpu.ops.pallas_texthead import reference_text_logprob as jax_reference
from mopoe_mimic_tpu_torch.ops import texthead as TH
from mopoe_mimic_tpu_torch.ops.cuda_texthead import texthead_cuda


def _case(B, L, C, V, seed=0):
    """test_pallas_texthead.py's inputs, as numpy: h, kernel [1, C, V],
    bias, targets with token 0 and V − 1 forced in."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, L, C)).astype(np.float32)
    kernel = (rng.normal(size=(1, C, V)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, size=(B, L)).astype(np.int32)
    targets[0, 0], targets[0, -1] = 0, V - 1
    return h, kernel, bias, targets


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,C,V", [(4, 128, 64, 3517), (3, 17, 10, 37), (2, 256, 128, 128)])
def test_forward_matches_jax(B, L, C, V):
    case = _case(B, L, C, V)
    got = TH.fused_text_logprob(*_torch(*case))
    ref = jax_fused(*map(jnp.asarray, case), interpret=True)
    assert got.shape == (B, L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TH.reference_text_logprob(*_torch(*case)).numpy(),
                               np.asarray(jax_reference(*map(jnp.asarray, case))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,C,V", [(3, 32, 24, 301), (3, 17, 10, 37)])
def test_gradients_match_jax(B, L, C, V):
    h, kernel, bias, targets = _case(B, L, C, V, seed=1)
    w = np.random.default_rng(2).normal(size=(B, L)).astype(np.float32)

    def jax_loss(h, k, b):
        return jnp.sum(w * jax_fused(h, k, b, jnp.asarray(targets), interpret=True))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (h, kernel, bias)))
    x = [t.requires_grad_() for t in _torch(h, kernel, bias)]
    lp = TH.fused_text_logprob(x[0], x[1], x[2], torch.from_numpy(targets))
    got = torch.autograd.grad((torch.from_numpy(w) * lp).sum(), x)
    for g, r, name in zip(got, ref, ("dh", "dkernel", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


def test_explicit_backward_matches_autograd():
    """The plain pair's backward (what the CUDA kernels compute) against
    autograd of the unfused float32 reference."""
    h, kernel, bias, targets = _case(3, 32, 24, 301, seed=3)
    h2, k2, b2 = (torch.from_numpy(h.reshape(-1, 24)), torch.from_numpy(kernel[0]),
                  torch.from_numpy(bias))
    t2 = torch.from_numpy(targets.reshape(-1))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(96,)).astype(np.float32))
    lp, lse = TH.texthead_fwd_plain(h2, k2, b2, t2)
    got = TH.texthead_bwd_plain(h2, k2, b2, t2, lse, g)
    x = [t.clone().requires_grad_() for t in (h2, k2, b2)]
    ref = torch.autograd.grad((g * TH.reference_text_logprob(*x, t2)).sum(), x)
    torch.testing.assert_close(lp, TH.reference_text_logprob(h2, k2, b2, t2), rtol=1e-5, atol=1e-5)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
    # float64 accumulation (the oracle chip_smoke.py uses for long sums)
    got64 = TH.texthead_bwd_plain(h2, k2, b2, t2, lse, g, acc_dtype=torch.float64)
    for a, r in zip(got64[1:], got[1:]):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a.float(), r, rtol=1e-4, atol=1e-5)


def test_bf16_inputs_match_jax():
    """bfloat16 h and kernel, float32 accumulation on both sides; dh comes
    back in bfloat16, dW rounded to the kernel's dtype as JAX rounds it."""
    h, kernel, bias, targets = _case(4, 128, 64, 3517, seed=5)
    ref = jax_fused(jnp.asarray(h, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bias),
                    jnp.asarray(targets), interpret=True)
    hb = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    got = TH.fused_text_logprob(hb, torch.from_numpy(kernel), torch.from_numpy(bias),
                                torch.from_numpy(targets))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    got.sum().backward()
    assert hb.grad.dtype == torch.bfloat16 and torch.isfinite(hb.grad.float()).all()


def test_targets_with_trailing_axis_and_kernel_shapes():
    h, kernel, bias, targets = _case(2, 8, 6, 11, seed=6)
    base = TH.fused_text_logprob(*_torch(h, kernel, bias, targets))
    flat = TH.fused_text_logprob(*_torch(h, kernel[0], bias, targets[..., None]))
    torch.testing.assert_close(base, flat, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    h, kernel, bias, targets = _case(2, 8, 6, 11, seed=7)
    with pytest.raises(ValueError, match="not a CUDA device"):
        texthead_cuda(torch.from_numpy(h.reshape(16, 6)), torch.from_numpy(kernel[0]),
                      torch.from_numpy(bias), torch.from_numpy(targets.reshape(16)))
