"""The port's epoch loop and experiment on the CPU
(mopoe_mimic_tpu_torch/train/loop.py, experiment.py, utils/preemption.py),
at small width (64 px, DIM 2, class_dim 4, vocab 50, batch 8, float32).

* tests/test_training_loop.py on the port: end to end, a resume at the
  end, an early stop, the checkpoint round trip; the eval round's sample
  grids rendered every round (no "not ported" warning since the eval round
  is ported); tests/test_preemption.py on the port.
* Of the heavy evaluation flags only ``calc_prd`` raises at construction
  (eval_lr, use_clf and calc_nll are ported), and so does the MIMIC
  dataset.
* Resume is bitwise, on the scanned path (the store and the epoch runners)
  and the per-step path, with dropout on: 2 epochs in one run equal 1
  epoch, then a new ``Experiment(name=...)`` resumed for 1 more, in
  parameters, BN buffers, Adam state and the generators' states.
* Against the JAX package: its ``run_epochs`` and the port's, 2 epochs × 2
  steps, from the same weights, patched as tests/test_torch_port_gate.py
  patches them (dropout off, z = mu, the two-pass BN variance), with
  ``device_resident_data`` true and false: every epoch's losses within the
  gate's bounds, the drift |port − jax| / max(1, |jax|) of the train loss
  below 2e-3 at the first epoch and 1e-2 after, of the test loss (eval
  mode, BN running statistics) below the gate's eval-mode 2e-2; the results
  CSV of each reads with pandas into the same columns.

  The test loss carries more drift than the train loss (2.2e-3 at the first
  epoch where the train loss drifts 1e-7, measured): gradients that are zero
  in exact arithmetic (a conv bias in front of a train-mode BatchNorm) hold
  rounding noise of either sign on both sides, which Adam's first steps
  turn into full-size updates of either sign; train mode's batch statistics
  cancel those biases, eval mode's running statistics do not.
"""

import logging
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import mopoe_mimic_tpu.evaluation.runner as jax_runner
import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.experiment import Experiment as JaxExperiment
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train.loop import run_epochs as jax_run_epochs
from mopoe_mimic_tpu.train.state import TrainState as JaxState
import mopoe_mimic_tpu_torch.models.mmvae as port_mmvae
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.experiment import HEAVY_EVALS, Experiment
from mopoe_mimic_tpu_torch.train.loop import run_epochs
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.utils.preemption import PreemptionGuard
from test_torch_port_train import TwoPassBatchNorm, no_dropout


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: the suite's
    workers share the cores, and all-core parallel regions on ops this
    small wait on each other's descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(tmp_path, **kw):
    base = dict(method="joint_elbo", dataset="testing", batch_size=8, class_dim=4, DIM_img=2,
                DIM_text=2, img_size=64, text_encoding="word", vocab_size=50,
                compute_dtype="float32", end_epoch=2, steps_per_training_epoch=2, eval_freq=10,
                seed=3, dir_experiment=str(tmp_path))
    base.update(kw)
    return base


def _cfg(tmp_path, **kw):
    return MopoeConfig(**_kw(tmp_path, **kw))


def _run(cfg, **kw):
    exp = Experiment(cfg, device="cpu")
    return exp, run_epochs(exp, device="cpu", **kw)


# ---------------------------------------------------------------------------
# tests/test_training_loop.py
# ---------------------------------------------------------------------------

def test_run_epochs_end_to_end(tmp_path):
    exp, result = _run(_cfg(tmp_path))
    assert np.isfinite(result["test"]["total_loss"]) and result["mean_epoch_time"] > 0
    assert set(result) == {"state", "train", "test", "history", "epochs_run", "preempted",
                           "mean_epoch_time"}
    assert [h["epoch"] for h in result["history"]] == [0, 1]
    for h in result["history"]:
        assert set(h["seconds"]) == {"train", "test", "callbacks", "checkpoint"}
    df = pd.read_csv(tmp_path / "experiments_dataframe.csv")
    assert (df["str_experiment"] == exp.name).any() and "mean_epoch_time" in df.columns
    assert pd.read_json(os.path.join(exp.paths["experiment_run"], "config.json"),
                        typ="series")["method"] == "joint_elbo"
    for key in ("checkpoints", "logs", "plot_random"):
        assert os.path.isdir(exp.paths[key])
    assert exp.checkpoints.latest_epoch() == 1  # the last epoch is a boundary


def test_resume_at_end_returns_without_error(tmp_path):
    _, result = _run(_cfg(tmp_path, start_epoch=5, end_epoch=2))
    assert result["epochs_run"] == 0 and result["train"] == {} and result["test"] == {}
    assert result["mean_epoch_time"] == 0.0


def test_early_stop_flushes_the_staged_best(tmp_path):
    exp, result = _run(_cfg(tmp_path, end_epoch=50, max_early_stopping_index=0,
                            checkpoint_freq=1000))
    assert result["epochs_run"] < 50
    losses = [h["test_loss"] for h in result["history"]]
    assert exp.checkpoints.best_epoch() == int(np.argmin(losses))


def test_eval_round_plots_are_warned_once(tmp_path, caplog):
    """The eval round's plots are ported: with ``save_figure`` every round
    writes its grids, and nothing is warned as not ported."""
    with caplog.at_level(logging.WARNING, logger="mopoe_mimic_tpu_torch"):
        exp, _ = _run(_cfg(tmp_path, end_epoch=3, eval_freq=1, save_figure=True))
    assert not [r for r in caplog.records if "not ported" in r.message]
    for epoch in range(3):
        for m in ("PA", "Lateral", "text"):
            assert os.path.isfile(os.path.join(exp.paths["plot_random"],
                                               f"random_{m}_{epoch}.png"))
        assert os.path.isfile(os.path.join(exp.paths["plot_cond"],
                                           f"cond_gen_Lateral_PA_text_{epoch}.png"))


def test_checkpoint_resume_roundtrip(tmp_path):
    exp, result = _run(_cfg(tmp_path, end_epoch=1, checkpoint_freq=1))
    assert exp.checkpoints.latest_epoch() == 0
    template = exp.init_state()
    epoch, restored = exp.checkpoints.restore(template)
    trained = result["state"]
    assert epoch == 0 and restored.step == trained.step == 2
    for (k, a), b in zip(trained.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# tests/test_preemption.py
# ---------------------------------------------------------------------------

def test_guard_latches_and_chains_previous_handler():
    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
        assert not guard.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested and seen == [signal.SIGUSR1]
        guard.uninstall()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert seen == [signal.SIGUSR1, signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_guard_request_off_main_thread():
    guard = PreemptionGuard()
    t = threading.Thread(target=guard.request)
    t.start()
    t.join()
    assert guard.requested


def test_preempted_run_checkpoints_and_resumes(tmp_path):
    cfg = _cfg(tmp_path, end_epoch=50, steps_per_training_epoch=1, eval_freq=1000,
               checkpoint_freq=1000)
    exp = Experiment(cfg, device="cpu")
    guard, seen_epochs = PreemptionGuard(), []
    write = exp.tb_logger.write_epoch

    def spying_write(split, epoch, avg):
        if split == "test":
            seen_epochs.append(epoch)
            if len(seen_epochs) == 2:
                guard.request()
        return write(split, epoch, avg)

    exp.tb_logger.write_epoch = spying_write
    result = run_epochs(exp, preemption=guard, device="cpu")
    assert result["preempted"] is True and result["epochs_run"] == 2
    stop_epoch = seen_epochs[-1]
    assert exp.checkpoints.latest_epoch() == stop_epoch

    cfg2 = cfg.replace(end_epoch=stop_epoch + 3)
    exp2 = Experiment(cfg2, name=exp.name, device="cpu")
    result2 = run_epochs(exp2, resume=True, preemption=None, device="cpu")
    assert result2["preempted"] is False and result2["epochs_run"] == 2
    assert np.isfinite(result2["test"]["total_loss"])


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", HEAVY_EVALS)
def test_heavy_eval_flags_raise(tmp_path, flag):
    """``calc_prd`` (PRD/FID) raises, naming the missing modules, before
    anything is made; eval_lr, use_clf and calc_nll are ported and accepted."""
    cfg = _cfg(tmp_path, **{flag: True})
    if flag == "calc_prd":
        with pytest.raises(NotImplementedError, match="calc_prd.*models/inception.py"):
            Experiment(cfg, device="cpu")
        assert not os.listdir(tmp_path)  # nothing made before refusing
    else:
        assert getattr(Experiment(cfg, device="cpu").cfg, flag)


def test_mimic_dataset_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="MIMIC"):
        Experiment(_cfg(tmp_path, dataset="Mimic"), device="cpu")


def test_run_epochs_on_another_device_than_the_experiment_raises(tmp_path):
    with pytest.raises(ValueError, match="experiment"):
        run_epochs(Experiment(_cfg(tmp_path), device="cpu"), device="meta")


def test_run_epochs_in_several_processes_raises(tmp_path, monkeypatch):
    """The agreement of several processes on the preemption flag is not
    ported: a group of more than one process is refused."""
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(NotImplementedError, match="preemption"):
        run_epochs(Experiment(_cfg(tmp_path), device="cpu"), device="cpu")


# ---------------------------------------------------------------------------
# the experiment's helpers, meters, TensorBoard, profiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("resident", [True, False], ids=["store", "loader"])
def test_eval_batches_and_host_jobs(tmp_path, resident):
    exp = Experiment(_cfg(tmp_path, device_resident_data=resident), device="cpu")
    batches = list(exp.eval_batches("test", epoch=1))
    assert len(batches) == 2 and batches[0][0]["PA"].shape == (8, 1, 64, 64)
    again = [b["text"] for b, _ in exp.eval_batches("test", epoch=1)]
    assert all(np.array_equal(np.asarray(a), np.asarray(b[0]["text"]))
               for a, b in zip(again, batches))
    done = []
    exp.submit_host_job(lambda: done.append(1), name="a")
    exp.submit_host_job(lambda: 1 / 0, name="fails")  # logged, not raised
    exp.submit_host_job(lambda: done.append(2), name="b")
    exp.drain_host_jobs()
    assert done == [1, 2]


def test_metric_accumulator_and_flatten():
    from mopoe_mimic_tpu_torch.utils.meters import (
        MetricAccumulator,
        fetch_scalar_tree,
        flatten_metrics,
    )

    acc = MetricAccumulator()
    for v in (1.0, 2.0, 6.0):
        acc.update({"loss": torch.tensor(v), "pair": (torch.tensor(v), torch.tensor(-v))})
    assert acc.count == 3
    assert acc.averages() == {"loss": 3.0, "pair": (3.0, -3.0)}
    assert fetch_scalar_tree({"a": torch.tensor(1.5)}) == {"a": 1.5}
    assert flatten_metrics({"a": {"b": 1.0, "c": np.array([2.0, 3.0])}, "d": "PA"}, sep="_") == {
        "a_b": 1.0, "a_c_0": 2.0, "a_c_1": 3.0, "d": "PA"}


def test_tensorboard_events_are_written_where_tensorboard_imports(tmp_path):
    exp, _ = _run(_cfg(tmp_path, end_epoch=1))
    exp.tb_logger.close()
    try:
        import tensorboard  # noqa: F401
    except ImportError:
        assert exp.tb_logger.writer is None
        return
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(exp.paths["logs"]))


def test_profiling_helpers(tmp_path):
    from mopoe_mimic_tpu_torch.utils.profiling import device_memory_stats, span, spans, trace

    with trace(str(tmp_path / "trace")):
        with span("matmul", rows=8) as sp:
            torch.ones(8, 8) @ torch.ones(8, 8)
    assert "matmul" in (tmp_path / "trace" / "trace.json").read_text()
    assert spans()[-1] is sp and sp.attrs == {"rows": 8}
    assert 0 < sp.start_ns < sp.end_ns and sp.seconds == (sp.end_ns - sp.start_ns) / 1e9
    assert device_memory_stats() == ({} if not torch.cuda.is_available() else
                                     device_memory_stats())


# ---------------------------------------------------------------------------
# resume is bitwise
# ---------------------------------------------------------------------------

def _train_state_tensors(state):
    opt = state.optimizer
    out = dict(state.model.state_dict())
    for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        out.update({f"adam/{i}/{k}": v for k, v in opt.state[p].items()})
    out.update(step_t=state.step_t, generator=state.generator.get_state(),
               default_generator=torch.get_rng_state())
    return out


@pytest.mark.parametrize("resident", [True, False], ids=["scanned", "per_step"])
def test_resume_is_bitwise(tmp_path, resident):
    kw = dict(device_resident_data=resident, checkpoint_freq=1000)
    _, straight = _run(_cfg(tmp_path / "a", **kw))
    ref = _train_state_tensors(straight["state"])
    first = Experiment(_cfg(tmp_path / "b", end_epoch=1, **kw), device="cpu")
    run_epochs(first, device="cpu")
    again = Experiment(_cfg(tmp_path / "b", **kw), name=first.name, device="cpu")
    resumed = run_epochs(again, resume=True, device="cpu")
    assert resumed["epochs_run"] == 1 and resumed["state"].step == straight["state"].step == 4
    got = _train_state_tensors(resumed["state"])
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        assert torch.equal(got[k], v), k
    assert resumed["history"][0]["train_loss"] == straight["history"][1]["train_loss"]
    assert any(isinstance(m, torch.nn.Dropout) and m.p > 0
               for m in resumed["state"].model.modules())


# ---------------------------------------------------------------------------
# against the JAX package's loop
# ---------------------------------------------------------------------------

def _jax_run(tmp_path, sd, resident):
    jcfg = JaxConfig(**_kw(tmp_path, device_resident_data=resident))
    exp = JaxExperiment(jcfg)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    state = JaxState(params=conv["params"], batch_stats=conv["batch_stats"],
                     opt_state=exp.tx.init(conv["params"]), step=jnp.zeros((), jnp.int32),
                     rng=jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        mp.setattr(jax_runner, "run_eval_suite", lambda *a, **k: {})
        result = jax_run_epochs(exp, state=state, preemption=None)
    exp.checkpoints.close()
    return result["history"]


def _port_run(tmp_path, sd, resident):
    cfg = _cfg(tmp_path, device_resident_data=resident)
    exp = Experiment(cfg, device="cpu")
    state = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(state.model)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mmvae, "reparameterize", lambda mu, lv, generator=None, eps=None: mu)
        result = run_epochs(exp, state=state, preemption=None, device="cpu")
    return result["history"]


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    """resident → (JAX history, port history, JAX CSV, port CSV)."""
    out = {}
    for resident in (True, False):
        root = tmp_path_factory.mktemp(f"resident_{resident}")
        sd = create_train_state(_cfg(root), device="cpu", seed=4).model.state_dict()
        out[resident] = (_jax_run(root / "jax", sd, resident), _port_run(root / "port", sd,
                                                                         resident),
                         root / "jax" / "experiments_dataframe.csv",
                         root / "port" / "experiments_dataframe.csv")
    return out


@pytest.mark.parametrize("resident", [True, False], ids=["scanned", "per_step"])
def test_run_epochs_matches_jax(loops, resident):
    ref, got, _, _ = loops[resident]
    assert [h["epoch"] for h in got] == [h["epoch"] for h in ref] == [0, 1]
    for i, (g, r) in enumerate(zip(got, ref)):
        for key in ("train_loss", "test_loss"):
            assert np.isfinite(r[key]), (i, key)
            drift = abs(g[key] - r[key]) / max(1.0, abs(r[key]))
            bound = 2e-2 if key == "test_loss" else 2e-3 if i == 0 else 1e-2
            assert drift < bound, (i, key, g[key], r[key])


@pytest.mark.parametrize("resident", [True, False], ids=["scanned", "per_step"])
def test_results_csv_has_the_jax_columns(loops, resident):
    _, _, jax_csv, port_csv = loops[resident]
    ref, got = pd.read_csv(jax_csv), pd.read_csv(port_csv)
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == 1
    for col in ("total_epochs", "best_epoch", "batch_size", "DIM_img", "method"):
        assert got[col][0] == ref[col][0], col
