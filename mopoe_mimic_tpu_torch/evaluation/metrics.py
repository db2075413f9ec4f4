"""Classification metrics (``mopoe_mimic_tpu/evaluation/metrics.py``;
reference Metrics at mimic/networks/classifiers/utils.py:286-413 —
accuracy, recall, specificity, precision, f1, jaccard, dice, mean average
precision, and predicted/ground-truth counts per label; threshold 0.5,
eps 1e-6).

The reference's mean_AP swaps the argument order of
``average_precision_score`` (it passes the prediction as y_true,
classifiers/utils.py:393-400). As the JAX package does, the port passes
y_true = ground truth and documents the deviation.

The average precision is numpy here (``average_precision``), with
scikit-learn's definition and order of operations: Σ (Rₙ − Rₙ₋₁)·Pₙ over
the distinct score thresholds in descending order, ties grouped; the card's
machine has no scikit-learn.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

EPS = 1e-6


class Metrics:
    def __init__(self, prediction: np.ndarray, groundtruth: np.ndarray, str_labels: Sequence[str]):
        self.str_labels = list(str_labels)
        self.prediction = np.asarray(prediction, dtype=np.float64)
        self.groundtruth = np.asarray(groundtruth, dtype=np.float64)
        self.pred_bin = (self.prediction > 0.5).astype(np.int64)
        self.gt_bin = (self.groundtruth > 0.5).astype(np.int64)

    def evaluate(self) -> Dict[str, List[float]]:
        tp = int((self.pred_bin * self.gt_bin).sum())
        tn = int(((1 - self.pred_bin) * (1 - self.gt_bin)).sum())
        fp = int((self.pred_bin * (1 - self.gt_bin)).sum())
        fn = int(((1 - self.pred_bin) * self.gt_bin).sum())
        total = self.pred_bin.size
        recall = tp / (tp + fn + EPS)
        precision = tp / (tp + fp + EPS)
        out = {
            "accuracy": [(tp + tn) / total],
            "recall": [recall],
            "specificity": [tn / (tn + fp + EPS)],
            "precision": [precision],
            "f1": [2 * recall * precision / (recall + precision + EPS)],
            "jaccard": [tp / (tp + fp + fn + EPS)],
            "dice": [2 * tp / (2 * tp + fp + fn + EPS)],
        }
        out.update(self.mean_ap())
        out.update(self.counts())
        return out

    def mean_ap(self) -> Dict[str, List[float]]:
        vals = {}
        for i, lbl in enumerate(self.str_labels):
            vals[f"mean_AP_{lbl}"] = [_safe_ap(self.gt_bin[:, i], self.prediction[:, i])]
        vals["mean_AP_total"] = [_safe_ap(self.gt_bin.ravel(), self.prediction.ravel())]
        return vals

    def counts(self) -> Dict[str, List[float]]:
        out = {}
        for i, lbl in enumerate(self.str_labels):
            out[f"pred_count_{lbl}"] = [float(self.pred_bin[:, i].sum())]
            out[f"gt_count_{lbl}"] = [float(self.gt_bin[:, i].sum())]
        return out


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Average precision of binary ``y_true`` (both classes present) under
    ``y_score``: scikit-learn's ``average_precision_score`` — the
    precision-recall curve over the distinct thresholds (a stable sort of
    the scores, descending; tied scores one threshold), reversed and closed
    with (recall 0, precision 1), and −Σ diff(recall)·precision[:-1]."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    thresholds = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresholds]
    fps = 1 + thresholds.astype(np.float64) - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _safe_ap(y_true: np.ndarray, y_score: np.ndarray) -> float:
    y_true = np.nan_to_num(np.asarray(y_true, dtype=np.float64))
    y_score = np.nan_to_num(np.asarray(y_score, dtype=np.float64))
    if len(np.unique(y_true)) < 2:
        return float("nan")
    return average_precision(y_true, y_score)


def eval_label_ap(values: np.ndarray, labels: np.ndarray, index: int) -> float:
    """Average precision for one label column (parity:
    MimicExperiment.eval_label, mimic/utils/experiment.py)."""
    return _safe_ap(labels[:, index], values[:, index])
