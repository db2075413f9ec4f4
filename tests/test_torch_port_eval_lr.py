"""lr-eval of the port (mopoe_mimic_tpu_torch/evaluation/representation.py)
against the JAX package's, float32, CPU, one intra-op thread.

* ``_fit_lr_batch`` on the same x, y gives the JAX fit's (w, b) within
  1e-5·max(1, max|ref|): both run 500 full-batch Adam steps on the same
  loss, and float32 rounding of the two frameworks' reductions drifts them
  apart (measured ≤ 3.3e-7).
* Through a tiny port ``Experiment`` and a JAX one on shared VAE weights
  (the JAX init with seeded noise, carried by ``state_dict_from_jax``):
  the subset means of the train split (rtol 1e-4, atol 1e-5·max(1,
  |ref|)), the fitted classifier's (w, b) within 1e-4·max(1, max|ref|)
  (measured ≤ 5.8e-6: the means' own rounding enters the fit), the test
  probabilities within 1e-4, and every test metric of every subset within
  2e-4 (measured: equal).

The helpers build the paired experiments for the other eval tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.evaluation import representation as jax_repr
from mopoe_mimic_tpu.experiment import Experiment as JaxExperiment
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.evaluation import representation as repr_
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.train.state import create_train_state
from test_torch_port_modules import assert_close, noisy

# a tiny testing_structured run: 32 train rows (4 batches), 8 test rows
KW = dict(method="joint_elbo", dataset="testing_structured", batch_size=8, class_dim=4,
          DIM_img=4, DIM_text=4, img_size=64, text_encoding="word", vocab_size=50,
          compute_dtype="float32", seed=3, synthetic_length=32, num_training_samples_lr=16,
          num_imp_samples=3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def paired(tmp_path, seed: int = 0, **kw):
    """(JAX experiment, its state, port experiment, its state) on the same
    weights: the JAX init with seeded noise on every leaf."""
    kw = {**KW, "dir_experiment": str(tmp_path / "runs"), "dir_clf": str(tmp_path / "clf"),
          **kw}
    jexp = JaxExperiment(JaxConfig(**kw))
    jstate = jexp.init_state()
    rng = np.random.default_rng(seed)
    variables = {"params": noisy(jax.device_get(jstate.params), rng),
                 "batch_stats": noisy(jax.device_get(jstate.batch_stats), rng)}
    jstate = jstate.replace(**variables)
    pcfg = MopoeConfig(**kw)
    pexp = Experiment(pcfg, device="cpu")
    pstate = create_train_state(pcfg, "cpu", state_dict=state_dict_from_jax(variables, pcfg))
    return jexp, jstate, pexp, pstate


def close(got, ref, rel: float) -> None:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_lr_batch_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k, n, d = 6, 40, 5
    y = rng.integers(0, 2, (k, n)).astype(np.float32)
    x = (rng.normal(size=(k, n, d)) * rng.uniform(0.1, 3.0, (k, 1, d))
         + 1.5 * y[..., None] * rng.normal(size=(k, 1, d)) + 2.0).astype(np.float32)
    w_ref, b_ref = jax.device_get(jax_repr._fit_lr_batch(jnp.asarray(x), jnp.asarray(y)))
    w, b = repr_._fit_lr_batch(torch.from_numpy(x), torch.from_numpy(y))
    close(w.numpy(), w_ref, 1e-5)
    close(b.numpy(), b_ref, 1e-5)


def test_lr_eval_all_subsets_matches_jax(tmp_path):
    jexp, jstate, pexp, pstate = paired(tmp_path)
    ref_means, ref_labels = jax_repr.collect_subset_means(jexp, jstate, jexp.eval_batches("train"),
                                                          max_samples=32)
    means, labels = repr_.collect_subset_means(pexp, pstate, pexp.eval_batches("train"),
                                               max_samples=32)
    np.testing.assert_array_equal(labels, ref_labels)
    assert means.keys() == ref_means.keys() and len(means) == 7
    for k in means:
        assert_close(means[k], ref_means[k])

    ref_clf = jax_repr.train_clf_lr_all_subsets(jexp, jstate)
    clf = repr_.train_clf_lr_all_subsets(pexp, pstate)
    assert clf.subset_keys == ref_clf.subset_keys and clf.label_names == ref_clf.label_names
    close(clf.w, ref_clf.w, 1e-4)
    close(clf.b, ref_clf.b, 1e-4)

    test_means, _ = repr_.collect_subset_means(pexp, pstate, pexp.eval_batches("test"), 8)
    probs, ref_probs = clf.predict_proba(test_means), ref_clf.predict_proba(test_means)
    for k in probs:
        np.testing.assert_allclose(probs[k], ref_probs[k], rtol=0, atol=1e-4)
    ref = jax_repr.test_clf_lr_all_subsets(jexp, jstate, ref_clf)
    got = repr_.test_clf_lr_all_subsets(pexp, pstate, clf)
    assert got.keys() == ref.keys()
    for s_key in ref:
        assert got[s_key].keys() == ref[s_key].keys()
        for name, v in ref[s_key].items():
            assert np.isnan(got[s_key][name]) == np.isnan(v), (s_key, name)
            if not np.isnan(v):
                assert abs(got[s_key][name] - v) <= 2e-4, (s_key, name, got[s_key][name], v)
