"""chip_smoke.py's phase 12 (the evaluation suite) rehearsed on the CPU at
small width (64 px, DIM 2, class_dim 4, vocab 50, batch 8, 32 rows,
float32), its checks as on the card where they do not need one: the
training CLI in processes of its own, epoch 0 training the classifiers
and a ``--load_run`` epoch 1 loading them from their ``.pt`` files, the CSV
row's eval values, TensorBoard's events, every grid as a PNG file of its
size; one eval round in this process, each result checked, no kernel
launched; each evaluation's device work against the CPU (here the CPU
against itself: exactly equal).
"""

import numpy as np

import chip_smoke
from mopoe_mimic_tpu_torch.config import MopoeConfig
from test_torch_port_eval_lr import one_thread  # noqa: F401

SMALL = ("--batch_size", "8", "--class_dim", "4", "--DIM_img", "2", "--DIM_text", "2",
         "--img_size", "64", "--vocab_size", "50", "--compute_dtype", "float32",
         "--synthetic_length", "32", "--num_training_samples_lr", "16")


def test_chip_smoke_eval_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "EVAL_ROOT", tmp_path / "eval_runs")
    out = chip_smoke.evaluation("cpu", "cpu", extra=SMALL)
    cli = out["cli"]
    assert [p["classifiers_trained"] for p in cli["processes"]] == [3, 0]
    assert [p["classifiers_loaded"] for p in cli["processes"]] == [0, 3]
    assert cli["plots"] == 2 * 10 and cli["csv_values"]["likelihoods_"] == 28
    for p in cli["processes"]:
        assert set(p["eval_round_s"]) >= {"round_s", "lr_eval_s", "clf_load_or_train_s",
                                          "coherence_s", "nll_s", "plots_collect_s"}
    assert set(out["round"]["seconds"]) == set(chip_smoke.EVALS)
    assert not any(out["round"]["launches"].values())
    assert all(v == 0.0 for v in out["gpu_against_cpu"]["max_err"].values())
    assert out["gpu_against_cpu"]["det_z_flips"] == {"tokens": 0, "rows": 0, "max_gap": 0.0}


def test_det_z_sample_errors_count_a_near_tie_flip():
    """A word-text token whose two best probabilities are tied to within the
    samples' error may argmax differently on the two sides: the flip is
    counted, its row is left out of the equal-input rows, its gap is at most
    twice the samples' error, and the CPU's token ids are handed back for
    the card's classifier. Images are never flipped."""
    cfg = MopoeConfig(text_encoding="word")
    rng = np.random.default_rng(0)
    ref = rng.random((3, 4, 6)).astype(np.float32)
    ref[1, 2, :2] = (0.990, 0.98999)  # row 1, position 2: a near tie
    ref[1, 2, 2:] = 0.0
    got = ref.copy()
    got[1, 2, 1] += 2e-5  # the other token wins on the other side
    img = rng.random((3, 1, 4, 4)).astype(np.float32)
    img_got = img + np.float32(1e-6)
    worst, flips = chip_smoke.det_z_sample_errors(
        cfg, {"PA_text": {"PA": img_got, "text": got}},
        {"PA_text": {"PA": img, "text": ref}})
    delta = float(np.abs(got - ref).max())
    assert worst == max(delta / float(ref.max()),
                        float(np.abs(img_got - img).max()) / float(img.max()))
    assert flips["tokens"] == 1 and flips["rows"] == 1
    assert 0.0 < flips["max_gap"] <= 2 * delta
    assert flips["same_rows"]["PA_text"]["text"].tolist() == [True, False, True]
    assert flips["same_rows"]["PA_text"]["PA"].all()
    np.testing.assert_array_equal(flips["ref_ids"]["text"]["PA_text"], ref.argmax(-1))
