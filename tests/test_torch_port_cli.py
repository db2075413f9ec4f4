"""The port's command line and training entry point on the CPU
(mopoe_mimic_tpu_torch/config.py, main.py, train/autotune.py).

* ``MopoeConfig.from_cli`` of the port equals the JAX package's on the same
  argv (the flagship's JSON under flags, booleans, tuples), and both refuse
  the same bad boolean.
* ``main([...], device="cpu")`` trains end to end at small width (64 px,
  DIM 2, vocab 50, batch 8, float32): the run directory, ``config.json``,
  the CSV row and the checkpoints; a NaN in the latents restarts with a
  new seed after wiping the run directory and its CSV row; the card out of
  memory retries at batch × 0.8, down to 8; ``load_flags`` keeps the flags
  given on the command line; ``--load_run`` resumes a run and keeps its
  ``dir_clf``.
* The batch autotune's doubling search with injected probes, as
  tests/test_autotune.py holds the JAX package's, and its OOM classifier.
"""

import dataclasses
import enum
import json
import os
import types

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu_torch import main as port_main
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.train.autotune import (
    autotune_batch_size,
    device_memory_bytes,
    is_oom_error,
)
from mopoe_mimic_tpu_torch.utils.exceptions import DeviceOutOfMemory, NaNInLatent

TENTPOLE = ["--config_path", "configs/flagship.json", "--dataset", "testing", "--eval_lr",
            "false", "--calc_nll", "false", "--use_clf", "false", "--device_resident_data",
            "true", "--fused_text_head", "true", "--bn_compute_dtype", "compute",
            "--lr_warmup_steps", "300"]
ARGVS = {
    "empty": [],
    "flagship": ["--config_path", "configs/flagship.json"],
    "tentpole": TENTPOLE,
    "booleans": ["--fused_pointwise", "yes", "--scan_epochs", "0", "--weighted_sampler", "T",
                 "--use_pallas_fusion", "n"],
    "numbers": ["--seed", "7", "--initial_learning_rate", "1e-4", "--batch_size", "64",
                "--bn_eps", "1e-3", "--mesh_shape", "2,4"],
    "json_under_flags": ["--config_path", "configs/flagship.json", "--method", "poe",
                         "--img_size", "64", "--eval_lr", "false"],
}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: the suite's
    workers share the cores, and all-core parallel regions on ops this
    small wait on each other's descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(value):
    return value.value if isinstance(value, enum.Enum) else value


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_from_cli_matches_jax(name, monkeypatch):
    monkeypatch.chdir(ROOT)
    got = dataclasses.asdict(MopoeConfig.from_cli(ARGVS[name]))
    ref = dataclasses.asdict(JaxConfig.from_cli(ARGVS[name]))
    assert {k: _plain(v) for k, v in got.items()} == {k: _plain(v) for k, v in ref.items()}


def test_bad_boolean_is_refused_like_jax():
    for cls in (MopoeConfig, JaxConfig):
        with pytest.raises(SystemExit):
            cls.from_cli(["--fused_text_head", "maybe"])


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def _argv(tmp_path, *extra):
    return ["--method", "joint_elbo", "--dataset", "testing", "--batch_size", "8",
            "--class_dim", "4", "--DIM_img", "2", "--DIM_text", "2", "--img_size", "64",
            "--text_encoding", "word", "--vocab_size", "50", "--compute_dtype", "float32",
            "--end_epoch", "2", "--steps_per_training_epoch", "2", "--eval_freq", "10",
            "--seed", "3", "--dir_experiment", str(tmp_path), "--eval_lr", "false",
            "--calc_nll", "false", "--use_clf", "false", *extra]


def _run_dirs(tmp_path):
    return sorted(p for p in os.listdir(tmp_path) if os.path.isdir(tmp_path / p))


def test_main_trains_end_to_end_on_the_cpu(tmp_path):
    result = port_main.main(_argv(tmp_path, "--checkpoint_freq", "1"), device="cpu")
    assert result["epochs_run"] == 2 and not result["preempted"]
    assert all(torch.isfinite(torch.tensor(h["train_loss"])) for h in result["history"])
    (run,) = _run_dirs(tmp_path)
    root = tmp_path / run
    with open(root / "config.json") as f:
        saved = json.load(f)
    assert (saved["DIM_img"], saved["seed"], saved["end_epoch"]) == (2, 3, 2)
    assert sorted(os.listdir(root / "checkpoints")) == ["0", "1"]
    csv = (tmp_path / "experiments_dataframe.csv").read_text().splitlines()
    assert len(csv) == 2 and csv[1].startswith(run + ",")
    assert next(iter(result["state"].model.parameters())).device.type == "cpu"


def test_device_flag_asks_for_the_cpu(tmp_path):
    result = port_main.main(_argv(tmp_path, "--end_epoch", "1", "--device", "cpu"))
    assert result["epochs_run"] == 1
    assert result["state"].step_t.device.type == "cpu"


def _spy_runs(monkeypatch, fail):
    """Wrap main's run_epochs: ``fail(call)`` may raise before the real run;
    returns the experiments seen, in call order."""
    seen = []
    real = port_main.run_epochs

    def spy(exp, **kw):
        seen.append(exp)
        fail(len(seen))
        return real(exp, **kw)

    monkeypatch.setattr(port_main, "run_epochs", spy)
    return seen


def test_nan_restart_wipes_the_run_and_takes_a_new_seed(tmp_path, monkeypatch):
    def fail(call):
        if call == 1:
            raise NaNInLatent("latent representations contain NaNs")

    seen = _spy_runs(monkeypatch, fail)
    # the fresh seed's draw, fixed
    monkeypatch.setattr(port_main, "np", types.SimpleNamespace(random=types.SimpleNamespace(
        default_rng=lambda: np.random.default_rng(1))))
    result = port_main.main(_argv(tmp_path, "--end_epoch", "1"), device="cpu")
    first, second = seen
    assert result["epochs_run"] == 1
    assert not os.path.exists(first.paths["experiment_run"])
    assert os.path.isdir(second.paths["experiment_run"])
    new_seed = int(np.random.default_rng(1).integers(0, 10000))
    assert (first.cfg.seed, second.cfg.seed) == (3, new_seed) and new_seed != 3
    assert second.cfg == first.cfg.replace(seed=new_seed)
    names = [line.split(",")[0] for line in
             (tmp_path / "experiments_dataframe.csv").read_text().splitlines()[1:]]
    assert names == [second.name]


@pytest.mark.parametrize("batch,retried", [(10, 8), (9, None)])
def test_out_of_memory_backs_the_batch_off(tmp_path, monkeypatch, batch, retried):
    def fail(call):
        if call == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    seen = _spy_runs(monkeypatch, fail)
    argv = _argv(tmp_path, "--end_epoch", "1", "--batch_size", str(batch))
    if retried is None:  # 9 × 0.8 < 8: the error stands
        with pytest.raises(torch.cuda.OutOfMemoryError):
            port_main.main(argv, device="cpu")
        assert len(seen) == 1
        return
    result = port_main.main(argv, device="cpu")
    assert [e.cfg.batch_size for e in seen] == [batch, retried]
    assert result["epochs_run"] == 1


def test_load_flags_keeps_the_flags_of_the_command_line(tmp_path):
    persisted = tmp_path / "config.json"
    old = MopoeConfig(batch_size=16, initial_learning_rate=3e-4, DIM_img=8,
                      dir_experiment="/elsewhere")
    persisted.write_text(json.dumps(old.to_dict()))
    argv = ["--batch_size", "4", "--dir_experiment", str(tmp_path)]
    cfg = port_main.load_flags(MopoeConfig.from_cli(argv), str(persisted),
                               skip={"batch_size", "dir_experiment"})
    assert (cfg.batch_size, cfg.initial_learning_rate, cfg.DIM_img) == (4, 3e-4, 8)
    assert cfg.dir_experiment == str(tmp_path)


def test_load_run_resumes_with_the_persisted_config(tmp_path):
    port_main.main(_argv(tmp_path, "--end_epoch", "1", "--checkpoint_freq", "1"), device="cpu")
    (run,) = _run_dirs(tmp_path)
    # the persisted config supplies the model's width; --end_epoch on this
    # command line wins over the persisted 1
    result = port_main.main(["--load_run", str(tmp_path / run), "--end_epoch", "2"],
                            device="cpu")
    assert result["epochs_run"] == 1 and result["history"][0]["epoch"] == 1
    assert _run_dirs(tmp_path) == [run]
    assert result["state"].model.cfg.DIM_img == 2 and result["state"].step == 4
    assert sorted(os.listdir(tmp_path / run / "checkpoints")) == ["0", "1"]
    rows = (tmp_path / "experiments_dataframe.csv").read_text().splitlines()
    assert len(rows) == 2  # the run's row reused, not a second one


def test_load_run_keeps_the_runs_dir_clf(tmp_path, monkeypatch):
    """``--load_run`` takes ``dir_clf`` from the run's config.json unless the
    command line gives it; the CLI resolves it against the working
    directory, so the run persists an absolute path."""
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.json").write_text(json.dumps(MopoeConfig(dir_clf=str(tmp_path / "clf"))
                                                .to_dict()))
    seen = []
    monkeypatch.setattr(port_main, "Main", lambda cfg, run_name, device: types.SimpleNamespace(
        main=lambda: seen.append(cfg.dir_clf)))
    monkeypatch.chdir(tmp_path)
    port_main.main(["--load_run", str(run)], device="cpu")
    port_main.main(["--load_run", str(run), "--dir_clf", "other"], device="cpu")
    port_main.main([], device="cpu")
    cwd = os.getcwd()
    assert seen == [str(tmp_path / "clf"), os.path.join(cwd, "other"),
                    os.path.normpath(os.path.join(cwd, "..", "clf"))]


# ---------------------------------------------------------------------------
# autotune (tests/test_autotune.py's injectable tests)
# ---------------------------------------------------------------------------

def test_is_oom_error_classification():
    assert is_oom_error(MemoryError())
    assert is_oom_error(DeviceOutOfMemory("x"))
    assert is_oom_error(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"))
    assert is_oom_error(RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"))
    assert not is_oom_error(ValueError("shape mismatch"))
    assert not is_oom_error(RuntimeError("NaN in latents"))


def _cfg(bs=8):
    return MopoeConfig(method="joint_elbo", dataset="testing", img_size=64, DIM_img=2,
                       DIM_text=2, class_dim=4, text_encoding="word", vocab_size=50,
                       batch_size=bs, compute_dtype="float32")


def test_autotune_doubles_until_budget():
    # 1 MiB a sample; a 100 MiB budget → batch 64
    best = autotune_batch_size(_cfg(8), max_batch=4096, budget_fraction=1.0,
                               memory_bytes=100 * 2**20, probe_fn=lambda c: c.batch_size * 2**20)
    assert best == 64


def test_autotune_stops_at_out_of_memory():
    def probe(cfg):
        if cfg.batch_size > 16:
            raise DeviceOutOfMemory(f"batch {cfg.batch_size}: CUDA out of memory")
        return cfg.batch_size

    assert autotune_batch_size(_cfg(8), budget_fraction=1.0, memory_bytes=10**9,
                               probe_fn=probe) == 16


def test_autotune_raises_when_nothing_fits():
    with pytest.raises(DeviceOutOfMemory):
        autotune_batch_size(_cfg(8), budget_fraction=1.0, memory_bytes=4,
                            probe_fn=lambda cfg: 10**9)


def test_autotune_keeps_batch_without_memory_info():
    assert autotune_batch_size(_cfg(8), memory_bytes=None, probe_fn=lambda c: 0,
                               device="cpu") == 8
    assert device_memory_bytes("cpu") is None


def test_chip_smoke_cli_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 10 (the CLI in a process of its own, in this
    process, and 1 + 1 epochs through --load_run against 2, bit for bit) at
    small width on the CPU, where no kernel launches."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "CLI_ROOT", tmp_path / "cli_runs")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the CLI's own process, as this one
    small = ("--img_size", "64", "--DIM_img", "4", "--DIM_text", "4", "--class_dim", "4",
             "--vocab_size", "30", "--batch_size", "8", "--synthetic_length", "64",
             "--compute_dtype", "float32")
    out = chip_smoke.cli_training("cpu", "card", 1.0, extra=small)
    assert out["resume_bitwise"] and not any(out["launches"].values())
    assert out["checkpoint_bytes"] > 0
    for where in ("process", "this_process"):
        assert len(out["loop_ms_per_step"][where]) == chip_smoke.CLI_EPOCHS
        assert all(set(e) == {"train", "test", "callbacks", "checkpoint"}
                   for e in out["split_s"][where])
