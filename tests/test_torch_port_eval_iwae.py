"""The IWAE likelihoods of the port (mopoe_mimic_tpu_torch/evaluation/
likelihood.py) against the JAX package's, float32, CPU, on shared VAE
weights (the paired experiments of test_torch_port_eval_lr.py), for word
text (length 128) and char text (length 1024).

The noise is JAX's own: the test derives each subset's eps [K·B, D] from
the batch key by the calls of likelihood.py:93-94 (a split per subset in
order, a split inside, ``jax.random.normal``) and injects it into the
port's estimator. Every subset × modality and the joint agree within
1e-5·max(1, |ref|) (measured ≤ 2.5e-7 for word and char): the estimates
are sums of log-probabilities over thousands of pixels and tokens, whose
float32 rounding stays far below it. The module's own pieces (the K-major regrouping, ``log_mean_exp``) are
checked against numpy.
"""

import jax
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.evaluation import likelihood as jax_lik
from mopoe_mimic_tpu_torch.evaluation import likelihood as lik
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device
from test_torch_port_eval_lr import one_thread, paired  # noqa: F401


def jax_eps(key, keys, n_imp: int, b: int, d: int) -> dict:
    """Each subset's eps as the JAX estimator draws it from ``key``."""
    out = {}
    for s in keys:
        key, r = jax.random.split(key)
        _, r_c = jax.random.split(r)
        out[s] = np.array(jax.random.normal(r_c, (n_imp * b, d), dtype=np.float32))
    return out


@pytest.mark.parametrize("encoding", ["word", "char"])
def test_iwae_matches_jax_with_its_eps(tmp_path, encoding):
    kw = {"text_encoding": encoding, **({"len_sequence": 1024} if encoding == "char" else {})}
    jexp, jstate, pexp, pstate = paired(tmp_path, **kw)
    cfg, keys, n_imp = pexp.cfg, list(pexp.subsets), pexp.cfg.num_imp_samples
    jbatch, _ = next(iter(jexp.eval_batches("test")))
    batch, _ = next(iter(pexp.eval_batches("test")))
    key = jax.random.PRNGKey(11)
    fn = jax_lik.make_likelihood_fn(jexp.cfg, jexp.model, keys)
    ref = jax.device_get(fn(jstate.params, jstate.batch_stats, jbatch, key))
    eps = jax_eps(key, keys, n_imp, cfg.batch_size, cfg.class_dim)

    model = pstate.model
    with eval_mode(cfg, model):
        got = lik.make_likelihood_fn(cfg, model, keys)(
            to_device(batch, next(model.parameters())),
            eps={s: torch.from_numpy(e) for s, e in eps.items()})
    assert list(got) == keys
    for s in keys:
        assert set(got[s]) == {*cfg.modality_names, "joint"} == set(ref[s])
        for m, r in ref[s].items():
            g = float(got[s][m])
            assert np.isfinite(r) and abs(g - r) <= 1e-5 * max(1.0, abs(float(r))), (s, m, g, r)


def test_repeat_is_k_major_and_log_mean_exp():
    a = torch.arange(6.0).reshape(3, 2)
    rep = lik._repeat(a, 4)
    assert rep.shape == (12, 2)
    for k in range(4):
        assert torch.equal(rep[3 * k: 3 * (k + 1)], a)
    x = np.random.default_rng(0).normal(size=(5, 7)) * 30
    ref = np.log(np.mean(np.exp(x - x.max(1, keepdims=True)), 1)) + x.max(1)
    np.testing.assert_allclose(lik.log_mean_exp(torch.from_numpy(x), 1)[:, 0].numpy(), ref,
                               rtol=1e-12)
