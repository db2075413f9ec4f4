"""Generation coherence of the port (mopoe_mimic_tpu_torch/evaluation/
coherence.py) against the JAX package's, float32, CPU, det-z: the JAX side
with ``reparameterize`` patched to return the mean (as
benchmarks/eval_parity.py:65 patches it), the port's with ``eps=0``; shared
VAE weights (the paired experiments of test_torch_port_eval_lr.py) and
shared classifiers (the JAX modules' init with seeded noise and heads
scaled by 0.01, which keeps most probabilities off 0 and 1, carried by
``classifier_state_dict_from_jax``); 16 test rows in 2 batches.

* The classifiers' probabilities of every subset's conditional samples of
  one batch: rtol 1e-4, atol 1e-5.
* ``test_generation``: the same keys; every conditional AP within 1e-6
  (the probabilities rank the rows alike); BLEU and the common words of
  every subset equal to 1e-12 (the argmaxed tokens are the same).
* Random coherence from one shared z: the same rate. (Each side's own
  random coherence draws from its own generator, so only its keys are
  compared.)
* ``run_eval_suite``'s flattened keys, in order, are the JAX suite's.
"""

import jax
import numpy as np
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.evaluation import coherence as jax_coh
from mopoe_mimic_tpu.evaluation import runner as jax_runner
from mopoe_mimic_tpu.evaluation.clf_loader import _make_predict
from mopoe_mimic_tpu.train import clf_trainer as jax_trainer
from mopoe_mimic_tpu.train.clf_trainer import ClfState
from mopoe_mimic_tpu_torch.evaluation import coherence as coh
from mopoe_mimic_tpu_torch.evaluation.runner import run_eval_suite
from mopoe_mimic_tpu_torch.models.jax_import import classifier_state_dict_from_jax
from mopoe_mimic_tpu_torch.train import clf_trainer
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device
from mopoe_mimic_tpu_torch.utils.meters import flatten_metrics
from test_torch_port_eval_lr import one_thread, paired  # noqa: F401
from test_torch_port_modules import noisy


def shared_classifiers(jexp, pexp, seed: int = 5):
    """(JAX evaluator, port evaluator) on the same classifier weights."""
    rng = np.random.default_rng(seed)
    jfns, models = {}, {}
    for m in jexp.cfg.modality_names:
        jmodel = jax_trainer.make_classifier(jexp.cfg, m, len(jexp.labels))
        x0 = np.asarray(jexp.dataset_train[0][0][m])[None]
        v = jax.device_get(jax.jit(lambda x: jmodel.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, x,
            train=True))(x0))
        v = {"params": noisy(v["params"], rng), "batch_stats": noisy(v["batch_stats"], rng)}
        # a head 100× smaller: on generated samples the noisy trunks' features
        # are large, and unscaled heads saturate most probabilities at 0 or 1
        v["params"]["linear"]["kernel"] = v["params"]["linear"]["kernel"] * 0.01
        jfns[m] = _make_predict(jmodel, ClfState(params=v["params"], batch_stats=v["batch_stats"],
                                                 opt_state=(), rng=jax.random.PRNGKey(0)))
        model = clf_trainer.make_classifier(pexp.cfg, m, len(pexp.labels))
        model.load_state_dict(classifier_state_dict_from_jax(v, pexp.cfg, m))
        models[m] = model.eval()
    return jax_coh.CoherenceEvaluator(jexp.cfg, jfns), coh.CoherenceEvaluator(pexp.cfg, models)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The paired experiments, 64 train and 16 test rows, and evaluators."""
    jexp, jstate, pexp, pstate = paired(tmp_path_factory.mktemp("coherence"),
                                        synthetic_length=64)
    return (jexp, jstate, pexp, pstate, *shared_classifiers(jexp, pexp))


@pytest.fixture
def det_z(monkeypatch):
    monkeypatch.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)


def test_coherence_det_z_matches_jax(pair, det_z):
    jexp, jstate, pexp, pstate, jev, pev = pair
    cfg, model = pexp.cfg, pstate.model

    # one batch's conditional samples through both classifier sets
    jbatch, _ = next(iter(jexp.eval_batches("test")))
    batch, _ = next(iter(pexp.eval_batches("test")))

    def go(m, b, train):
        return m.cond_generation(m.inference(b, train=train)["subsets"], train=train)

    jcond = jexp.model.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                             jbatch, train=False, rngs={"reparam": jax.random.PRNGKey(0)},
                             method=go)
    ref = jev.predict_cond_probs(jax.device_get(jcond))
    with eval_mode(cfg, model):
        cond = model.cond_generation(
            model.inference(to_device(batch, next(model.parameters())))["subsets"], eps=0.0)
    got = pev.predict_cond_probs(cond)
    assert got.keys() == ref.keys() and len(got) == 7
    for s in ref:
        for m in ref[s]:
            assert 0.02 < ref[s][m].mean() < 0.98
            np.testing.assert_allclose(got[s][m], ref[s][m], rtol=1e-4, atol=1e-5)

    # the whole pass
    ref_res = jax_coh.test_generation(jexp, jstate, jev)
    res = coh.test_generation(pexp, pstate, pev, eps=0.0)
    assert flatten_metrics(res).keys() == flatten_metrics(ref_res).keys()
    assert list(res["cond_coherence"]) == list(ref_res["cond_coherence"]) == pexp.labels
    flat, ref_flat = flatten_metrics(res["cond_coherence"]), flatten_metrics(
        ref_res["cond_coherence"])
    for k, v in ref_flat.items():
        assert np.isnan(flat[k]) == np.isnan(v), k
        if not np.isnan(v):
            assert abs(flat[k] - v) <= 1e-6, (k, flat[k], v)
    for s, scores in ref_res["text_gen"].items():
        for k, v in scores.items():
            assert abs(res["text_gen"][s][k] - v) <= 1e-12, (s, k)


def test_random_coherence_from_a_shared_z(pair):
    jexp, jstate, pexp, pstate, jev, pev = pair
    z = np.random.default_rng(9).normal(size=(16, pexp.cfg.class_dim)).astype(np.float32)
    jsamples = jax.device_get(jexp.model.apply(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, z, train=False,
        method=lambda m, z, train: m.generate_from_latents(z, train=train)))
    model = pstate.model
    with eval_mode(pexp.cfg, model):
        samples = model.generate_from_latents(torch.from_numpy(z))
    ref = jev.calculate_coherence(jsamples, jexp.labels)
    got = pev.calculate_coherence(samples, pexp.labels)
    assert got == pytest.approx(ref, abs=1e-7)
    assert got == pev.calculate_coherence({m: v.numpy() for m, v in samples.items()}, pexp.labels)


def test_run_eval_suite_keys_match_jax(pair, tmp_path):
    """``run_eval_suite``'s flattened keys equal the JAX suite's on the same
    config (tests/test_eval_runner.py:47: eval_lr, use_clf and calc_nll on),
    each side's evaluator the shared classifiers (nothing trained)."""
    jexp, jstate, pexp, pstate, jev, pev = pair
    on = dict(eval_lr=True, use_clf=True, calc_nll=True)
    jexp.cfg, pexp.cfg = jexp.cfg.replace(**on), pexp.cfg.replace(**on)
    jexp._coherence_evaluator, pexp._coherence_evaluator = jev, pev
    ref = jax_runner.run_eval_suite(jexp, jstate, epoch=0, max_batches=1)
    jexp.drain_host_jobs()
    got = run_eval_suite(pexp, pstate, epoch=0, max_batches=1)
    pexp.drain_host_jobs()
    assert list(got) == list(ref)
    for prefix in ("lr_eval_", "gen_eval_", "likelihoods_"):
        assert any(k.startswith(prefix) for k in got), prefix
    assert set(pexp.eval_timings) >= {"lr_eval_s", "clf_load_or_train_s", "coherence_s",
                                      "nll_s", "plots_collect_s", "round_s"}
