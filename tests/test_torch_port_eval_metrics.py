"""The port's classification metrics and BLEU against the JAX package's
(mopoe_mimic_tpu_torch/evaluation/{metrics,bleu}.py; numpy only, no
JAX program is compiled).

* ``Metrics.evaluate`` equals the JAX package's to 1e-12 on random
  predictions, with NaN inputs and a single-class column (whose AP is NaN
  on both sides).
* The port's numpy ``average_precision`` equals scikit-learn's
  ``average_precision_score`` to 1e-12 (exactly, in practice), with tied
  scores; ``_safe_ap`` maps NaN inputs to 0 and a single class to NaN, as
  the JAX package's does.
* BLEU: the cases of tests/test_eval_math.py (the token path, the id path
  with and without the reference tables, the common words) give the JAX
  package's scores to 1e-12, and nltk's where nltk is installed.
"""

import numpy as np
import pytest
from sklearn.metrics import average_precision_score

from mopoe_mimic_tpu.evaluation import bleu as jax_bleu
from mopoe_mimic_tpu.evaluation.metrics import Metrics as JaxMetrics
from mopoe_mimic_tpu.evaluation.metrics import _safe_ap as jax_safe_ap
from mopoe_mimic_tpu_torch.evaluation import bleu
from mopoe_mimic_tpu_torch.evaluation.metrics import Metrics, _safe_ap, average_precision
from test_eval_math import _nltk_quintuple

LABELS = ["Lung Opacity", "Pleural Effusion", "Support Devices"]


def _same(got: dict, ref: dict, tol: float = 1e-12) -> None:
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        g, r = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(r)), k
        np.testing.assert_allclose(g[~np.isnan(g)], r[~np.isnan(r)], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("seed", range(6))
def test_metrics_evaluate_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    pred = np.round(rng.random((n, 3)), int(rng.integers(1, 4)))  # rounding makes ties
    gt = rng.integers(0, 2, (n, 3)).astype(np.float64)
    if seed % 2:
        pred[rng.random((n, 3)) < 0.1] = np.nan
        gt[:, 1] = 1.0  # a single-class column: its AP is NaN
    ref = JaxMetrics(pred, gt, LABELS).evaluate()
    got = Metrics(pred, gt, LABELS).evaluate()
    _same(got, ref)
    if seed % 2:
        assert np.isnan(got["mean_AP_Pleural Effusion"][0])


@pytest.mark.parametrize("seed", range(4))
def test_average_precision_matches_sklearn(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(200):
        n = int(rng.integers(2, 80))
        y = rng.integers(0, 2, n)
        if len(np.unique(y)) < 2:
            continue
        s = np.round(rng.random(n), int(rng.integers(0, 3)))  # 0 decimals: mostly ties
        assert abs(average_precision(y, s) - average_precision_score(y, s)) <= 1e-12


def test_safe_ap_nan_inputs_and_single_class():
    y = np.array([1.0, 0.0, np.nan, 1.0, 0.0])
    s = np.array([0.9, np.nan, 0.2, 0.4, 0.4])
    assert _safe_ap(y, s) == jax_safe_ap(y, s) == average_precision_score(
        np.nan_to_num(y), np.nan_to_num(s))
    assert np.isnan(_safe_ap(np.ones(4), np.arange(4.0)))
    assert np.isnan(jax_safe_ap(np.ones(4), np.arange(4.0)))


BLEU_CASES = [
    ([["no", "focal", "consolidation", "pleural", "effusion", "or", "pneumothorax"],
      ["mild", "pulmonary", "edema", "with", "small", "effusions"],
      ["the", "lungs", "are", "clear"]],
     [["no", "consolidation", "pleural", "effusion", "seen"],
      ["pulmonary", "edema", "with", "effusions", "noted", "today"],
      ["lungs", "clear"]]),
    ([["a", "b", "c", "d", "e"]], [["a", "b", "c", "d", "e"]]),
    ([["a", "x", "b", "y", "c"]], [["a", "q", "b", "r", "c"]]),
    ([["a", "b", "c", "d", "e", "f", "g", "h"]], [["a", "b", "c"]]),
    ([["a", "b", "c"], ["d", "e", "f"]], [["a", "b", "c"], []]),
    ([["the", "the", "cat"]], [["the", "the", "the", "the"]]),
    ([["the", "cat", "sat"], ["a", "dog", "ran", "far"]], [["xx"], ["yy"]]),
]


@pytest.mark.parametrize("case", range(len(BLEU_CASES)))
def test_corpus_bleu_matches_jax_and_nltk(case):
    refs, hyps = BLEU_CASES[case]
    got = bleu.corpus_bleu(refs, hyps)
    _same(got, jax_bleu.corpus_bleu(refs, hyps))
    assert bleu.nbr_common_words(refs, hyps) == jax_bleu.nbr_common_words(refs, hyps)
    pytest.importorskip("nltk")
    _same(got, _nltk_quintuple(refs, hyps))


@pytest.mark.parametrize("vocab,length", [(40, 32), (3517, 128)])
def test_corpus_bleu_ids_matches_jax(vocab, length):
    rng = np.random.default_rng(3)
    refs = rng.integers(0, vocab, size=(16, length))
    hyps = refs.copy()
    mask = rng.random(refs.shape) < 0.4
    hyps[mask] = rng.integers(0, vocab + 50, size=int(mask.sum()))  # some ids no ref uses
    tables = bleu.build_ref_tables(refs)
    ref = jax_bleu.corpus_bleu_ids(refs, hyps)
    _same(bleu.corpus_bleu_ids(refs, hyps), ref)
    _same(bleu.corpus_bleu_ids(refs, hyps, ref_tables=tables), ref)
    table = [f"tok{i}" for i in range(vocab + 50)]
    _same(ref, jax_bleu.corpus_bleu([[table[i] for i in r] for r in refs],
                                    [[table[i] for i in h] for h in hyps]))
    want = jax_bleu.nbr_common_words_ids(refs, hyps)
    assert bleu.nbr_common_words_ids(refs, hyps) == want
    assert bleu.nbr_common_words_ids(refs, hyps, ref_tables=tables) == want
