"""Serving a run directory of the port's training CLI, at small width on
the CPU (mopoe_mimic_tpu_torch/serve.py, utils/save_samples.py,
data/text_codec.py, data/vocab.py), and chip_smoke.py's phase 11 rehearsed
here.

* ``python -m mopoe_mimic_tpu_torch.main --text_encoding char`` trains 2
  epochs in a process of its own (chip_smoke's ``char_cli_training`` at
  small width) and leaves its run directory.
* ``InferenceSession(run_dir=...)`` serves the epoch the JAX package's
  manager picks (the best test loss, else the latest; orbax's order with
  NaN losses, which tiny runs have) and is bit for bit the session on that
  checkpoint's state_dict.
* The serve CLI writes PNG grids, which PIL decodes back to the grid
  (``_to_grid``, the same as the JAX package's), and the text arrays.
* ``text_array`` and ``decode_text`` equal the JAX session's on the same
  strings, char and word (word through a persisted vocabulary).
* ``--mode export`` raises, naming why.
"""

import json
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.serve import InferenceSession as JaxSession
from mopoe_mimic_tpu.train.state import TrainState as JaxState
from mopoe_mimic_tpu.train.state import make_optimizer as jax_optimizer
from mopoe_mimic_tpu.utils.checkpoints import CheckpointManager as JaxManager
from mopoe_mimic_tpu.utils.plotting import _to_grid as jax_to_grid
from mopoe_mimic_tpu_torch import main as train_cli
from mopoe_mimic_tpu_torch import serve as port_serve
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.vocab import Vocab
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.utils.checkpoints import CheckpointManager
from mopoe_mimic_tpu_torch.utils.save_samples import _to_grid, png_bytes

SMALL = ("--img_size", "64", "--DIM_img", "4", "--DIM_text", "4", "--class_dim", "4",
         "--vocab_size", "30", "--batch_size", "8", "--synthetic_length", "64",
         "--compute_dtype", "float32")
NAN = float("nan")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models (as
    tests/test_torch_port_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"char": the char CLI's run directory (its own process), "word": a
    word run of the CLI in this process}, both 2 epochs at small width."""
    root = tmp_path_factory.mktemp("serve_runs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "CHAR_ROOT", root / "char_runs")
        mp.setenv("OMP_NUM_THREADS", "1")  # the CLI's own process, as this one
        char = chip_smoke.char_cli_training("cpu", extra=SMALL)
    train_cli.main(chip_smoke.cli_argv(root / "word_runs", *SMALL), device="cpu")
    (word,) = [p for p in (root / "word_runs").iterdir() if p.is_dir()]
    return {"char": char["run"], "word": word}


def test_char_cli_run_directory(runs):
    run = runs["char"]
    saved = json.loads((run / "config.json").read_text())
    assert saved["text_encoding"] == "char" and saved["len_sequence"] == 1024
    assert CheckpointManager(str(run / "checkpoints")).all_epochs() == [0, 1]


@pytest.mark.parametrize("text", ["char", "word"])
def test_session_on_a_run_directory_is_the_state_dict_session(runs, text):
    run = runs[text]
    sess = InferenceSession(run_dir=str(run), device="cpu")
    mgr = CheckpointManager(str(run / "checkpoints"))
    best = mgr.best_epoch()
    assert sess.epoch == (mgr.latest_epoch() if best is None else best)
    _, payload = mgr.read(sess.epoch)
    direct = InferenceSession(sess.cfg, state_dict=payload["model"], device="cpu")
    for k, v in direct.model.state_dict().items():
        assert torch.equal(sess.model.state_dict()[k], v), k
    batch = chip_smoke.request(sess.cfg, 5, seed=3)
    got, ref = sess.encode(batch), direct.encode(batch)
    for key in ref["subsets"]:
        for a, b in zip(got["subsets"][key], ref["subsets"][key]):
            assert np.array_equal(a, b), key
    assert InferenceSession(run_dir=str(run), epoch=0, device="cpu").epoch == 0
    with pytest.raises(ValueError):
        InferenceSession(sess.cfg, run_dir=str(run), device="cpu")


# test losses a run's epochs report, NaN included (a tiny run's eval pass)
SEQUENCES = {"all_nan": [NAN, NAN, NAN], "nan_first": [NAN, 3.0, 2.5],
             "nan_between": [2.0, NAN, 2.5], "nan_last": [3.0, 2.0, NAN],
             "no_metrics": [None, None, None], "finite": [2.0, 1.0, 3.0]}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_session_serves_the_epoch_the_jax_manager_picks(runs, tmp_path, name):
    """The char run's last checkpoint as epochs 0-2 with ``name``'s test
    losses: the port's session serves the epoch that the JAX manager
    (orbax) picks from the same losses, saved through it."""
    losses = SEQUENCES[name]
    src = runs["char"]
    run = tmp_path / "run"
    (run / "checkpoints").mkdir(parents=True)
    shutil.copy(src / "config.json", run / "config.json")
    for epoch, loss in enumerate(losses):
        shutil.copytree(src / "checkpoints" / "1", run / "checkpoints" / str(epoch))
        metrics = None if loss is None else {"test_loss": loss}
        (run / "checkpoints" / str(epoch) / "metrics.json").write_text(json.dumps(metrics))
    jcfg = JaxConfig(initial_learning_rate=1e-3)
    tx = jax_optimizer(jcfg)
    params = {"w": jnp.zeros((2,))}
    state = JaxState(params=params, batch_stats={}, opt_state=tx.init(params),
                     step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    j_mgr = JaxManager(str(tmp_path / "jax"), async_save=False)
    for epoch, loss in enumerate(losses):
        j_mgr.save(epoch, state, metrics=None if loss is None else {"test_loss": loss})
    best = j_mgr.best_epoch()
    want = j_mgr.latest_epoch() if best is None else best
    j_mgr.close()
    assert InferenceSession(run_dir=str(run), device="cpu").epoch == want


def test_serve_cli_writes_png_grids_and_text(runs, tmp_path):
    """The CLI's PNGs decode (PIL) to the grid of the session's samples,
    ``_to_grid`` being the JAX package's; text as probabilities, or ids
    with ``--compact``."""
    from PIL import Image

    run = runs["char"]
    sess = InferenceSession(run_dir=str(run), device="cpu")
    for compact in (False, True):
        samples = sess.generate(11, seed=5, compact=compact)
        out = tmp_path / f"out_{compact}"
        port_serve.main(["--run_dir", str(run), "--num_samples", "11", "--seed", "5",
                         "--device", "cpu", "--out", str(out)] + ["--compact"] * compact)
        for m in ("PA", "Lateral"):
            assert (out / f"{m}.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
            images = samples[m].astype(np.float32) / 255.0 if compact else samples[m]
            grid = _to_grid(images)
            assert np.array_equal(grid, jax_to_grid(images))
            with Image.open(out / f"{m}.png") as png:
                assert png.mode == "L"
                decoded = np.asarray(png)
            assert decoded.shape == (2 * 64, 8 * 64)
            assert np.array_equal(decoded, (grid * 255).astype(np.uint8)[..., 0])
        name = "text_ids.npy" if compact else "text_probs.npy"
        assert np.array_equal(np.load(out / name), samples["text"])
    assert not (run / "serving").exists()  # --out given: nothing under the run


def test_png_bytes_rgb_and_refusals():
    from io import BytesIO

    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    with Image.open(BytesIO(png_bytes(rgb))) as png:
        assert png.mode == "RGB" and np.array_equal(np.asarray(png), rgb)
    with pytest.raises(ValueError):
        png_bytes(rgb.astype(np.float32))
    with pytest.raises(ValueError):
        png_bytes(np.zeros((4, 4, 2), np.uint8))


REPORTS = ["No acute cardiopulmonary process.", "the lungs are clear; no effusion",
           "Mild cardiomegaly, ET tube 4 cm above the carina. é ~"]


@pytest.mark.parametrize("text", ["char", "word"])
def test_text_array_and_decode_text_match_jax(tmp_path, text):
    kw = dict(img_size=64, DIM_img=4, DIM_text=4, class_dim=4, text_encoding=text,
              dir_data=str(tmp_path), word_min_occ=0)
    if text == "word":
        vocab = Vocab.build(REPORTS * 2, min_occ=0)
        vocab.save(str(tmp_path / "files_small_64"), 0, 128)
        kw["vocab_size"] = vocab.vocab_size
    jax_self = types.SimpleNamespace(cfg=JaxConfig(**kw))
    sess = InferenceSession(MopoeConfig(**kw), device="cpu")
    got, ref = sess.text_array(REPORTS), JaxSession.text_array(jax_self, REPORTS)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    probs = np.random.default_rng(1).random((3, sess.cfg.len_sequence, sess.cfg.num_features),
                                            dtype=np.float32)
    for arr in (probs, probs.argmax(-1).astype(np.int32), got):
        assert sess.decode_text(arr) == JaxSession.decode_text(jax_self, arr)
    if text == "char":
        assert sess.decode_text(got)[0].startswith(REPORTS[0].lower() + "$")


def test_export_mode_raises(runs):
    with pytest.raises(NotImplementedError, match="ctypes"):
        port_serve.main(["--run_dir", str(runs["char"]), "--mode", "export", "--device", "cpu"])


def test_chip_smoke_serving_phase_rehearses_on_cpu(runs):
    """chip_smoke.py's phase 11 serving pieces at small width on the CPU:
    the serve CLI in its own process on the char and the word run, and the
    session on the char run (the card adds the launches and timings)."""
    for text in ("char", "word"):
        out = chip_smoke.serve_cli(runs[text], "cpu")
        assert out["png_size"] == [8 * 64, 2 * 64]
    cfg = MopoeConfig.from_json(str(runs["word"] / "config.json"))
    assert out["text_probs_shape"] == [16, 128, cfg.vocab_size]
    res = chip_smoke.serve_run_dir(runs["char"], "cpu", timed=False)
    assert res["epoch"] == chip_smoke.served_epoch(runs["char"])
    assert not any(res["launches"].values())
