"""Classifier training: the CheXpert-label classifiers that the coherence
evaluation consumes (``mopoe_mimic_tpu/train/clf_trainer.py``).

Parity: mimic/networks/classifiers/main_train_clf_mimic.py:49-199 and
classifiers/utils.py:102-238 — a multi-label classifier per modality, BCE
or dice loss (mimic/utils/loss.py:51-79), Adam, early stopping on the mean
average precision (the dice where it is NaN) keeping the best epoch's
weights, and the results CSV.

Under ``cfg.device_resident_data`` the batches are gathered on the card
from a single-modality ``DeviceStore``, otherwise they come from the host
``BatchLoader``; the orders are the JAX package's. Initialisation and
dropout draw from PyTorch's default generators, seeded with ``cfg.seed``
inside ``torch.random.fork_rng``: training a classifier leaves the
generators of the VAE's run as it found them, so an evaluation round does
not move a resumed run off its straight twin. The DenseNet classifier
(``img_clf_type="densenet"``) and its crop transforms are not ported.

    python -m mopoe_mimic_tpu_torch.train.clf_trainer --config_path cfg.json [--device cpu]
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch
from torch import nn

from mopoe_mimic_tpu_torch.data.loader import BatchLoader
from mopoe_mimic_tpu_torch.evaluation.metrics import Metrics
from mopoe_mimic_tpu_torch.models.classifiers import ClfImg, ClfText
from mopoe_mimic_tpu_torch.train.step import to_device
from mopoe_mimic_tpu_torch.utils.logger import log

DENSENET_MISSING = ("img_clf_type='densenet': the DenseNet/CheXNet classifier "
                    "(models/densenet.py) and its crop transforms are not ported "
                    "(ROADMAP queue 1 item 9); use img_clf_type='resnet'")


def make_classifier(cfg, modality: str, n_labels: int) -> nn.Module:
    if modality == "text":
        # the classifier reads this run's text tensors and the VAE's
        # generated text, so its encoding follows the data's
        # (clf_trainer.py:38-57 of the JAX package)
        enc = cfg.text_clf_type
        if enc not in ("char", "word") or enc != cfg.text_encoding:
            if enc in ("char", "word"):
                log.warning(f"text_clf_type={enc!r} does not match text_encoding="
                            f"{cfg.text_encoding!r}; the coherence classifier follows the "
                            "data encoding")
            enc = cfg.text_encoding
        return ClfText(n_labels, dim=cfg.DIM_text, text_encoding=enc,
                       num_features=cfg.num_features, vocab_size=cfg.vocab_size,
                       len_sequence=cfg.len_sequence)
    if cfg.img_clf_type == "densenet":
        raise NotImplementedError(DENSENET_MISSING)
    return ClfImg(n_labels, img_size=cfg.img_size, image_channels=cfg.image_channels)


def make_clf_input_fn(cfg, modality: str) -> Callable:
    """The classifier's input adapter: the identity for the resnet and text
    classifiers; the DenseNet path's crops are not ported."""
    if modality != "text" and cfg.img_clf_type == "densenet":
        raise NotImplementedError(DENSENET_MISSING)
    return lambda x: x


def clf_loss_fn(kind: str) -> Callable:
    """BCE (probabilities clipped to [1e-6, 1 − 1e-6]) or dice over sigmoid
    probabilities (mimic/utils/loss.py:51-79)."""

    def bce(probs, targets):
        p = torch.clamp(probs, 1e-6, 1 - 1e-6)
        return -torch.mean(targets * torch.log(p) + (1 - targets) * torch.log(1 - p))

    def dice(probs, targets, smooth=1.0):
        inter = torch.sum(probs * targets)
        return 1.0 - (2 * inter + smooth) / (torch.sum(probs) + torch.sum(targets) + smooth)

    if kind in ("binary_crossentropy", "bce_with_logits", "crossentropy"):
        return bce
    if kind == "dice":
        return dice
    raise NotImplementedError(kind)


def _rng_fork(device: torch.device):
    """The default generators of the CPU and of ``device``, restored on exit."""
    return torch.random.fork_rng(devices=[device] if device.type == "cuda" else [],
                                 device_type="cuda")


def train_classifier(
    cfg,
    modality: str,
    dataset_train,
    dataset_eval,
    n_labels: int,
    max_epochs: int = 100,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[nn.Module, Dict[str, float]]:
    """(the classifier with its best epoch's weights, in eval mode, on
    ``device``; that epoch's eval metrics), the run written to the results
    CSV under ``cfg.dir_clf``."""
    device = torch.device(device)
    seed = cfg.seed or 0
    prep = make_clf_input_fn(cfg, modality)
    loss_fn = clf_loss_fn(cfg.clf_loss)
    if cfg.device_resident_data:
        from mopoe_mimic_tpu_torch.data.device_store import DeviceStore

        store_tr = DeviceStore(dataset_train, cfg, columns=(modality,), device=device)
        store_ev = DeviceStore(dataset_eval, cfg, columns=(modality,), device=device)

        def train_batches(epoch):
            return store_tr.iter_epoch(epoch, cfg.batch_size, seed=seed)

        def eval_batches():
            return store_ev.iter_epoch(0, cfg.batch_size, shuffle=False)
    else:
        loader = BatchLoader(dataset_train, cfg.batch_size, shuffle=True, seed=seed)
        eval_loader = BatchLoader(dataset_eval, cfg.batch_size, shuffle=False)

        def train_batches(epoch):
            loader.set_epoch(epoch)
            return iter(loader)

        def eval_batches():
            return iter(eval_loader)
    labels = [f"l{i}" for i in range(n_labels)]
    steps_cap = cfg.steps_per_training_epoch if cfg.steps_per_training_epoch > 0 else None

    with _rng_fork(device):
        torch.manual_seed(seed)
        model = make_classifier(cfg, modality, n_labels).to(device)
        param = next(model.parameters())
        opt = torch.optim.Adam(model.parameters(), lr=cfg.initial_learning_rate,
                               betas=(cfg.beta_1, cfg.beta_2), eps=1e-8)
        best_metric, best_weights, best_results, bad = -math.inf, None, {}, 0
        epoch = 0
        for epoch in range(max_epochs):
            model.train()
            loss = torch.zeros((), device=device)
            for i, (batch, y) in enumerate(train_batches(epoch)):
                if steps_cap and i >= steps_cap:
                    break
                x = prep(to_device({modality: batch[modality]}, param)[modality])
                loss = loss_fn(model(x), torch.as_tensor(y, device=device, dtype=param.dtype))
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
            # eval: the mean AP, the early stop's target (classifiers/utils.py:130-203)
            preds, gts = [], []
            model.eval()
            with torch.no_grad():
                for batch, y in eval_batches():
                    preds.append(model(prep(to_device({modality: batch[modality]},
                                                      param)[modality])))
                    gts.append(y)
            pred = torch.cat(preds).cpu().numpy()
            results = {k: v[0] for k, v in Metrics(pred, np.concatenate(gts), labels)
                       .evaluate().items()}
            target = results.get("mean_AP_total")
            target = results["dice"] if (target is None or math.isnan(target)) else target
            log.info(f"clf[{modality}] epoch {epoch}: loss={float(loss.detach()):.4f} "
                     f"target={target:.4f}")
            if target > best_metric:
                best_metric, best_results, bad = target, results, 0
                best_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
            else:
                bad += 1
                if bad > cfg.clf_early_stop_patience:
                    break
    if best_weights is not None:
        model.load_state_dict(best_weights)
    _write_clf_df(cfg, modality, epoch, best_results)
    return model.eval(), best_results


def _write_clf_df(cfg, modality: str, total_epochs: int, best_results: Dict[str, float]) -> None:
    """The classifiers' results CSV (clf_experiments_dataframe.csv,
    mimic/networks/classifiers/utils.py:47-89): one row per classifier
    training run, the config, the best eval metrics and the epochs
    trained."""
    try:
        from mopoe_mimic_tpu_torch.utils.experiment_df import ExperimentDataframe

        os.makedirs(cfg.dir_clf, exist_ok=True)
        run = f"clf_{modality}_{time.strftime('%Y_%m_%d_%H_%M_%S')}"
        df = ExperimentDataframe(f"{cfg.dir_clf}/clf_experiments_dataframe.csv", cfg, run)
        df.update({"modality": modality, "total_epochs": total_epochs,
                   **{f"best_{k}": v for k, v in best_results.items()}})
    except OSError as e:
        log.warning(f"clf results CSV not written: {e}")


def main(argv=None) -> None:
    """Train, or load where cached, the classifier of every modality of the
    configured experiment, and store the weights under ``dir_clf``, where
    the coherence evaluation of any run with the same dataset fingerprint
    finds them (networks/classifiers/main_train_clf_mimic.py:97-132)."""
    from mopoe_mimic_tpu_torch.config import MopoeConfig
    from mopoe_mimic_tpu_torch.evaluation.clf_loader import load_or_train_classifiers
    from mopoe_mimic_tpu_torch.experiment import Experiment
    from mopoe_mimic_tpu_torch.main import _pop_option

    argv = list(argv if argv is not None else sys.argv[1:])
    device = _pop_option(argv, "--device") or "cuda"
    load_or_train_classifiers(Experiment(MopoeConfig.from_cli(argv), device=device))


if __name__ == "__main__":
    main()
