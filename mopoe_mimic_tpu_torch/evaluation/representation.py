"""Latent-representation evaluation: linear classifiers on the subset
posteriors' means (``mopoe_mimic_tpu/evaluation/representation.py``;
reference mimic/evaluation/eval_metrics/representation.py:20-187).

The reference fits one scikit-learn LogisticRegression per (subset, label).
As the JAX package does, the port fits all |subsets| × |labels| binary
logistic regressions at once: full-batch Adam (lr 0.1, 500 iterations) on
one [S·L, D] weight matrix, with the ridge 0.5/n·|w|² of scikit-learn's
C = 1, on standardised inputs (population std, as ``jnp.std``), folded back
into (w, b) after the fit. Its gap to scikit-learn is the JAX package's
(docs/EVAL_PARITY.json).

Flow: encode at least ``num_training_samples_lr`` training samples into
subset means (``MMVae.inference``: K1's forward on the card), resample
until every label has both classes (representation.py:73-87), fit; then
encode the test set, predict, and score each subset with ``Metrics``
(representation.py:91-145).
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from mopoe_mimic_tpu_torch.evaluation.metrics import Metrics
from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device

LR_ITERS, LR_RATE, ADAM_B1, ADAM_B2, ADAM_EPS = 500, 0.1, 0.9, 0.999, 1e-8


def collect_subset_means(exp, state, loader, max_samples: int
                         ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Inference over ``loader``'s batches in eval mode until
    ``max_samples`` rows: ({subset: [N, D] means}, labels [N, L]). The means
    stay on the device until the last batch."""
    cfg, model = exp.cfg, state.model
    param = next(model.parameters())
    collected: Dict[str, list] = {}
    labels_all, n = [], 0
    with eval_mode(cfg, model):
        for batch, labels in loader:
            subsets = model.inference(to_device(batch, param))["subsets"]
            for k, (mu, _) in subsets.items():
                collected.setdefault(k, []).append(mu)
            labels_all.append(np.asarray(labels))
            n += len(labels)
            if n >= max_samples:
                break
    # subsets in sorted order, as the JAX package's device_get of a dict gives them
    data = {k: torch.cat(collected[k])[:max_samples].float().cpu().numpy()
            for k in sorted(collected)}
    return data, np.concatenate(labels_all)[:max_samples]


def resample_both_classes(data: Mapping[str, np.ndarray], labels: np.ndarray, n_samples: int,
                          rng: np.random.Generator, max_tries: int = 1000):
    """A random subsample holding both classes of every label
    (get_random_labels, representation.py:73-87)."""
    if not any(len(np.unique(labels[:, i])) > 1 for i in range(labels.shape[1])):
        raise ValueError("labels must contain at least two classes")
    n = labels.shape[0]
    for _ in range(max_tries):
        idx = rng.integers(0, n, size=n_samples)
        sub = labels[idx]
        if all(len(np.unique(sub[:, i])) > 1 for i in range(labels.shape[1])):
            return {k: v[idx] for k, v in data.items()}, sub
    raise ValueError("could not sample both classes; increase batch size")


def _fit_lr_batch(x: torch.Tensor, y: torch.Tensor, iters: int = LR_ITERS,
                  lr: float = LR_RATE) -> Tuple[torch.Tensor, torch.Tensor]:
    """K independent binary logistic regressions: x [K, N, D], y [K, N] →
    (w [K, D], b [K]) on x's device. Full-batch Adam (optax's update) from
    zeros on the mean of the logistic loss plus 0.5/n·|w|², each problem
    standardised by its mean and population std (+1e-6), which the result
    folds back in."""
    k, n, d = x.shape
    mean = x.mean(dim=1, keepdim=True)
    std = x.std(dim=1, correction=0, keepdim=True) + 1e-6
    xs = (x - mean) / std
    zero = xs.new_zeros(())
    w = torch.zeros((k, d), dtype=x.dtype, device=x.device, requires_grad=True)
    b = torch.zeros((k,), dtype=x.dtype, device=x.device, requires_grad=True)
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in (w, b)]
    with torch.enable_grad():
        for t in range(1, iters + 1):
            logits = torch.einsum("knd,kd->kn", xs, w) + b[:, None]
            ll = torch.mean(torch.maximum(logits, zero) - logits * y
                            + torch.log1p(torch.exp(-torch.abs(logits))), dim=1)
            loss = torch.sum(ll + 0.5 / n * torch.sum(w * w, dim=1))
            grads = torch.autograd.grad(loss, (w, b))
            with torch.no_grad():
                for p, g, (m, v) in zip((w, b), grads, moments):
                    m.mul_(ADAM_B1).add_((1 - ADAM_B1) * g)
                    v.mul_(ADAM_B2).add_((1 - ADAM_B2) * (g * g))
                    m_hat = m / (1 - ADAM_B1 ** t)
                    v_hat = v / (1 - ADAM_B2 ** t)
                    p.sub_(lr * (m_hat / (torch.sqrt(v_hat) + ADAM_EPS)))
    w_orig = w.detach() / std[:, 0, :]
    b_orig = b.detach() - torch.sum(w_orig * mean[:, 0, :], dim=1)
    return w_orig, b_orig


class LatentClassifier:
    """All (subset × label) logistic regressions in one weight matrix."""

    def __init__(self, subset_keys, label_names, w: np.ndarray, b: np.ndarray):
        self.subset_keys = list(subset_keys)
        self.label_names = list(label_names)
        self.w = w  # [S*L, D]
        self.b = b

    def predict_proba(self, data: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """{subset: [N, L] probabilities}."""
        out = {}
        n_l = len(self.label_names)
        for si, s_key in enumerate(self.subset_keys):
            x = np.asarray(data[s_key])
            w = self.w[si * n_l: (si + 1) * n_l]  # [L, D]
            b = self.b[si * n_l: (si + 1) * n_l]
            out[s_key] = 1.0 / (1.0 + np.exp(-(x @ w.T + b)))
        return out


def train_clf_lr_all_subsets(exp, state) -> LatentClassifier:
    cfg = exp.cfg
    data, labels = collect_subset_means(
        exp, state, exp.eval_batches("train"),
        max_samples=max(cfg.num_training_samples_lr * 2, cfg.effective_eval_batch_size))
    rng = np.random.default_rng(cfg.seed or 0)
    data, labels = resample_both_classes(data, np.nan_to_num(labels),
                                         cfg.num_training_samples_lr, rng)
    subset_keys = list(data.keys())
    n_l = labels.shape[1]
    # the problems stacked: [S*L, N, D]
    x = np.stack([np.nan_to_num(data[s]) for s in subset_keys for _ in range(n_l)])
    y = np.stack([labels[:, i] for _ in subset_keys for i in range(n_l)])
    device = next(state.model.parameters()).device
    w, b = _fit_lr_batch(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))
    return LatentClassifier(subset_keys, exp.labels, w.cpu().numpy(), b.cpu().numpy())


def test_clf_lr_all_subsets(exp, state, clf: LatentClassifier) -> Dict[str, Dict[str, float]]:
    """The latent classifiers' metrics on the test set, by subset
    (representation.py:91). A library function, not a test: the name is the
    reference's."""
    data, labels = collect_subset_means(exp, state, exp.eval_batches("test"),
                                        max_samples=len(exp.dataset_test))
    labels = np.nan_to_num(labels)
    probs = clf.predict_proba({k: np.nan_to_num(v) for k, v in data.items()})
    return {s_key: {k: v[0] for k, v in Metrics(p, labels, exp.labels).evaluate().items()}
            for s_key, p in probs.items()}


# keep pytest from collecting the reference-parity-named library function
test_clf_lr_all_subsets.__test__ = False
