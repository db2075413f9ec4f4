"""The port's CheXpert-label classifiers and their training
(mopoe_mimic_tpu_torch/models/classifiers.py, train/clf_trainer.py,
evaluation/clf_loader.py) against the JAX package's, float32, CPU.

* ``ClfImg`` at 64 and 128 px and ``ClfText`` (word at length 128, char at
  length 1024): the JAX module's variables with seeded noise (running
  variances ×4-16, which keep the activations O(1) through the a = 2 skips),
  carried by ``classifier_state_dict_from_jax``; the eval-mode
  probabilities agree within rtol 1e-4, atol 1e-5.
* ``clf_loss_fn``: BCE and dice as JAX's, 1e-6 relative.
* The text classifier follows the data's encoding
  (tests/test_clf_trainer.py:92); ``train_classifier`` writes its results
  CSV (tests/test_clf_trainer.py:44) and returns the best epoch's weights;
  the classifier cache (``<_clf_dir>.pt``, beside the JAX orbax path) is
  written, and a second experiment loads it instead of training.
* DenseNet is not ported and raises, naming ROADMAP queue 1 item 9.
* The classifiers' CLI trains and stores every modality's classifier.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.evaluation.clf_loader import _clf_dir as jax_clf_dir
from mopoe_mimic_tpu.train import clf_trainer as jax_trainer
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.evaluation import clf_loader
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.models.classifiers import ClfImg, ClfText
from mopoe_mimic_tpu_torch.models.jax_import import classifier_state_dict_from_jax
from mopoe_mimic_tpu_torch.train import clf_trainer
from test_torch_port_eval_lr import one_thread  # noqa: F401
from test_torch_port_modules import noisy

SMALL = dict(dataset="testing", batch_size=8, class_dim=4, DIM_img=4, DIM_text=8, img_size=64,
             vocab_size=50, compute_dtype="float32", seed=0)


def _inputs(cfg, modality, rng, n=3):
    if modality != "text":
        return rng.random((n, cfg.img_size, cfg.img_size, 1), dtype=np.float32)
    if cfg.text_encoding == "word":
        ids = rng.integers(0, cfg.vocab_size, (n, cfg.len_sequence)).astype(np.int32)
        ids[:, -9:] = 0  # padding, which the embedding masks
        return ids
    return np.eye(71, dtype=np.float32)[rng.integers(0, 71, (n, cfg.len_sequence))]


@pytest.mark.parametrize("modality,kw", [
    ("PA", {"img_size": 64}), ("Lateral", {"img_size": 128}),
    ("text", {"text_encoding": "word"}), ("text", {"text_encoding": "char", "len_sequence": 1024}),
], ids=["img64", "img128", "word128", "char1024"])
def test_classifier_forward_matches_jax(modality, kw):
    jcfg, pcfg = JaxConfig(**{**SMALL, **kw}), MopoeConfig(**{**SMALL, **kw})
    rng = np.random.default_rng(0)
    x = _inputs(jcfg, modality, rng)
    jmodel = jax_trainer.make_classifier(jcfg, modality, 3)
    variables = jax.device_get(jax.jit(lambda v: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}, v, train=True))(x))
    variables = {"params": noisy(variables["params"], rng),
                 "batch_stats": noisy(variables["batch_stats"], rng)}
    ref = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(variables, x))
    model = clf_trainer.make_classifier(pcfg, modality, 3)
    assert isinstance(model, ClfText if modality == "text" else ClfImg)
    model.load_state_dict(classifier_state_dict_from_jax(variables, pcfg, modality))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy() if x.ndim == 4 else x)
    with torch.no_grad():
        got = model.eval()(xt).numpy()
    assert ref.shape == got.shape == (3, 3) and np.isfinite(ref).all()
    assert 0.02 < ref.mean() < 0.98  # not saturated: the comparison sees the logits
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_converter_checks_the_embedding():
    cfg = MopoeConfig(**SMALL, text_encoding="char")
    with pytest.raises(ValueError, match="embedding"):
        classifier_state_dict_from_jax({"params": {"embedding": {"embedding": np.zeros((2, 2))}}},
                                       cfg, "text")


@pytest.mark.parametrize("kind", ["binary_crossentropy", "dice"])
def test_clf_loss_matches_jax(kind):
    rng = np.random.default_rng(1)
    probs = rng.random((16, 3)).astype(np.float32)
    probs[0, 0], probs[1, 1] = 0.0, 1.0  # the BCE clip
    targets = rng.integers(0, 2, (16, 3)).astype(np.float32)
    ref = float(jax_trainer.clf_loss_fn(kind)(probs, targets))
    got = float(clf_trainer.clf_loss_fn(kind)(torch.from_numpy(probs), torch.from_numpy(targets)))
    assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))
    with pytest.raises(NotImplementedError):
        clf_trainer.clf_loss_fn("hinge")


def test_text_clf_follows_data_encoding():
    cfg = MopoeConfig(**SMALL, text_encoding="char")
    assert cfg.text_clf_type == "word"  # the mismatched default
    model = clf_trainer.make_classifier(cfg, "text", 3)
    assert isinstance(model, ClfText) and not model.word
    x = np.zeros((2, cfg.len_sequence, 71), np.float32)
    x[:, :, 0] = 1.0
    with torch.no_grad():
        assert model.eval()(torch.from_numpy(x)).shape == (2, 3)


def test_train_classifier_writes_csv_twin(tmp_path):
    cfg = MopoeConfig(**SMALL, steps_per_training_epoch=1, dir_clf=str(tmp_path / "clf"))
    before = torch.get_rng_state()
    model, results = clf_trainer.train_classifier(
        cfg, "PA", SyntheticMimic(cfg, seed=0, length=16), SyntheticMimic(cfg, seed=1, length=16),
        n_labels=3, max_epochs=2, device="cpu")
    assert torch.equal(torch.get_rng_state(), before)  # the run's generators untouched
    assert results and not model.training
    row = pd.read_csv(tmp_path / "clf" / "clf_experiments_dataframe.csv").iloc[0]
    assert row["modality"] == "PA" and any(c.startswith("best_") for c in row.index)


def test_classifier_cache_is_written_and_reloaded(tmp_path, caplog):
    cfg = MopoeConfig(**{**SMALL, "dataset": "testing_structured"}, synthetic_length=16,
                      steps_per_training_epoch=1, clf_quick_epochs=1, use_clf=True,
                      dir_experiment=str(tmp_path / "runs"), dir_clf=str(tmp_path / "clf"))
    trained = clf_loader.load_or_train_classifiers(Experiment(cfg, device="cpu"))
    for m in cfg.modality_names:
        path = clf_loader.clf_weights_path(cfg, m)
        jax_dir = jax_clf_dir(JaxConfig(**cfg.to_dict()), m)
        assert path.is_file() and path == jax_dir.with_name(jax_dir.name + ".pt")
        assert not clf_loader._clf_dir(cfg, m).exists()  # the JAX package's orbax path
    exp = Experiment(cfg, device="cpu")
    caplog.clear()
    with caplog.at_level("INFO", logger="mopoe_mimic_tpu_torch"):
        loaded = clf_loader.load_or_train_classifiers(exp)
    assert sum("loaded classifier" in r.message for r in caplog.records) == 3
    assert not any("training classifier" in r.message for r in caplog.records)
    assert clf_loader.load_or_train_classifiers(exp) is loaded  # cached on the experiment
    for m in cfg.modality_names:
        for (k, a), b in zip(trained.classifiers[m].state_dict().items(),
                             loaded.classifiers[m].state_dict().values()):
            assert torch.equal(a, b), (m, k)


def test_densenet_raises(tmp_path):
    cfg = MopoeConfig(**SMALL, img_clf_type="densenet")
    for call in (lambda: clf_trainer.make_classifier(cfg, "PA", 3),
                 lambda: clf_trainer.make_clf_input_fn(cfg, "PA"),
                 lambda: Experiment(cfg.replace(use_clf=True, dir_experiment=str(tmp_path)),
                                    device="cpu")):
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            call()
    assert isinstance(clf_trainer.make_classifier(cfg, "text", 3), ClfText)


def test_clf_trainer_cli_trains_and_stores_the_classifiers(tmp_path):
    """``python -m mopoe_mimic_tpu_torch.train.clf_trainer`` (its ``main``):
    the classifier of every modality trained and stored under ``dir_clf``."""
    clf_trainer.main(["--dataset", "testing_structured", "--batch_size", "8", "--img_size",
                      "64", "--DIM_text", "4", "--text_encoding", "word", "--vocab_size", "50",
                      "--synthetic_length", "16", "--steps_per_training_epoch", "1",
                      "--clf_quick_epochs", "1", "--dir_experiment", str(tmp_path / "runs"),
                      "--dir_clf", str(tmp_path / "clf"), "--device", "cpu"])
    stored = sorted(p.name for p in (tmp_path / "clf").rglob("*.pt"))
    assert stored == ["clf_Lateral_64.pt", "clf_PA_64.pt", "clf_text_word_128.pt"]
