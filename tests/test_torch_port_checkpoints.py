"""The port's callbacks and checkpoints on the CPU
(mopoe_mimic_tpu_torch/train/callbacks.py, utils/checkpoints.py).

* tests/test_callbacks.py's three tests on the port: early stopping on a
  rising loss, the checkpoint cadence, ReduceLROnPlateau scaling the lr.
* tests/test_checkpoints.py's tests on the port, but the buffer-donation
  one (a TPU matter): saves durable without ``close``, a plateau never
  evicts the best, saves without metrics kept, the staged best flushed on
  a read and superseded, and written by ``close``.
* One sequence of test losses fed through the JAX package's ``Callbacks``
  and ``CheckpointManager`` (orbax) and through the port's: after every
  epoch the same epochs on disk and the same lr; at the end the same
  epochs, best and latest.
* ``restore`` puts a checkpoint back in place (the same tensors, the
  learning rates tensors on the parameters' device) and a step after it is
  the step after the save, bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.train import callbacks as jax_callbacks
from mopoe_mimic_tpu.train.state import TrainState as JaxState
from mopoe_mimic_tpu.train.state import get_learning_rate as jax_lr
from mopoe_mimic_tpu.train.state import make_optimizer as jax_optimizer
from mopoe_mimic_tpu.utils.checkpoints import CheckpointManager as JaxManager
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.train.callbacks import Callbacks, ReduceLROnPlateau
from mopoe_mimic_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    get_learning_rate,
    make_optimizer,
)
from mopoe_mimic_tpu_torch.train.step import make_train_step
from mopoe_mimic_tpu_torch.utils.checkpoints import CheckpointManager, kept_epochs
from test_torch_port_train import no_dropout, numpy_batch, port_batch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: the suite's
    workers share the cores, and all-core parallel regions on ops this
    small wait on each other's descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_state(v: float = 0.0, lr: float = 1e-3) -> TrainState:
    """A TrainState of a 2 → 3 linear layer whose weight is all ``v``."""
    model = torch.nn.Linear(2, 3)
    with torch.no_grad():
        model.weight.fill_(v)
    cfg = MopoeConfig(initial_learning_rate=lr)
    return TrainState(model, make_optimizer(cfg, model.parameters(), "cpu"), int(v),
                      torch.Generator().manual_seed(0), torch.zeros(()))


def weight(state) -> float:
    return float(state.model.weight[0, 0].detach())


# ---------------------------------------------------------------------------
# callbacks (tests/test_callbacks.py)
# ---------------------------------------------------------------------------

class _FakeCkpt:
    def __init__(self):
        self.saved = []

    def save(self, epoch, state, force=False):
        self.saved.append(epoch)


def test_early_stopping_on_rising_loss():
    cb = Callbacks(MopoeConfig(max_early_stopping_index=2, end_epoch=100),
                   checkpoint_manager=_FakeCkpt())
    stops = [cb.update_epoch(epoch, loss, None)[0]
             for epoch, loss in enumerate([10.0, 9.0, 9.5, 9.6, 9.7, 9.8])]
    # improvement at epoch 1, then the third epoch without one stops
    assert stops == [False, False, False, False, True, True]
    assert 0 in cb.ckpt.saved and 1 in cb.ckpt.saved


def test_checkpoint_every_freq():
    cb = Callbacks(MopoeConfig(max_early_stopping_index=100, checkpoint_freq=3, end_epoch=10),
                   checkpoint_manager=_FakeCkpt())
    for epoch in range(8):
        cb.update_epoch(epoch, 100.0 + epoch, None)  # never improves after 0
    assert 2 in cb.ckpt.saved and 5 in cb.ckpt.saved  # (epoch + 1) % 3 == 0


def test_reduce_lr_on_plateau_scales_base_lr_in_place():
    state = tiny_state(lr=1e-3)
    base_lr = state.optimizer.param_groups[0]["base_lr"]
    assert abs(get_learning_rate(state) - 1e-3) < 1e-9
    sched = ReduceLROnPlateau(patience=1, factor=0.1)
    for loss in (1.0, 2.0, 2.0):  # best, bad 1, bad 2 > patience → scale
        state = sched.step(state, loss)
    assert abs(get_learning_rate(state) - 1e-4) < 1e-9
    assert state.optimizer.param_groups[0]["base_lr"] is base_lr  # the same tensor


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoints.py)
# ---------------------------------------------------------------------------

def test_saves_are_durable_without_close(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(9, tiny_state(9.0), metrics={"test_loss": 5.0})
    mgr.save(11, tiny_state(11.0), metrics={"test_loss": 3.0})
    (tmp_path / "ck" / "12.tmp").mkdir()  # a save that a crash cut short
    # abandoned without close(): a fresh manager sees both epochs
    fresh = CheckpointManager(str(tmp_path / "ck"))
    assert fresh.all_epochs() == [9, 11] and not (tmp_path / "ck" / "12.tmp").exists()
    state = tiny_state(0.0)
    epoch, restored = fresh.restore(state, epoch=11)
    assert epoch == 11 and restored is state and weight(state) == 11.0 and state.step == 11


def test_plateau_never_evicts_best(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    losses = [5.0, 2.0, 4.0, 4.5, 4.6, 4.7, 4.8]
    for epoch, loss in enumerate(losses):
        mgr.save(epoch, tiny_state(float(epoch)), metrics={"test_loss": loss})
    kept = set(mgr.all_epochs())
    assert 1 in kept, "the best checkpoint (epoch 1, loss 2.0) was evicted"
    assert mgr.best_epoch() == 1 and mgr.latest_epoch() == len(losses) - 1
    assert len(losses) - 1 in kept, "the latest must survive for resume"
    state = tiny_state()
    assert mgr.restore(state, epoch=mgr.best_epoch())[0] == 1 and weight(state) == 1.0
    assert mgr.restore(state)[0] == len(losses) - 1 and weight(state) == 6.0


def test_metricless_saves_are_retained(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=1)
    mgr.save(0, tiny_state(0.0))  # a periodic save before any test pass
    mgr.save(1, tiny_state(1.0), metrics={"test_loss": 3.0})
    assert 0 in mgr.all_epochs()


def test_staged_best_flushes_on_read_and_supersede(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.save(0, tiny_state(0.0), metrics={"test_loss": 9.0})
    mgr.stage(1, tiny_state(1.0), {"test_loss": 5.0})
    mgr.stage(2, tiny_state(2.0), {"test_loss": 3.0})  # supersedes epoch 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["0"]  # nothing written by a stage
    assert mgr.latest_epoch() == 2 and 1 not in mgr.all_epochs() and mgr.best_epoch() == 2
    # an older staged best is written before a newer save
    mgr.stage(3, tiny_state(3.0), {"test_loss": 2.0})
    mgr.save(4, tiny_state(4.0), metrics={"test_loss": 4.0})
    assert {3, 4} <= set(mgr.all_epochs())
    state = tiny_state()
    mgr.restore(state, epoch=3)
    assert weight(state) == 3.0


def test_staged_state_is_a_copy(tmp_path):
    """The train state changes in place after a stage: the staged copy
    does not."""
    mgr = CheckpointManager(str(tmp_path / "ck"))
    state = tiny_state(1.0)
    mgr.stage(1, state, {"test_loss": 1.0})
    with torch.no_grad():
        state.model.weight.fill_(7.0)
    mgr.flush_staged()
    restored = tiny_state()
    mgr.restore(restored, epoch=1)
    assert weight(restored) == 1.0


def test_staged_best_persisted_by_close(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    mgr.stage(5, tiny_state(5.0), {"test_loss": 1.0})
    mgr.close()
    assert CheckpointManager(str(tmp_path / "ck"), max_to_keep=2).latest_epoch() == 5


def test_kept_epochs_is_orbax_best_n_plus_latest():
    infos = [(0, None), (1, {"test_loss": 3.0}), (2, {"test_loss": 1.0}),
             (3, {"test_loss": 2.0}), (4, {"test_loss": 2.0}), (5, {"test_loss": 9.0})]
    assert kept_epochs(infos, 2) == [0, 2, 4, 5]  # a later epoch first among equal losses
    assert kept_epochs(infos[:2], 3) == [0, 1]


# ---------------------------------------------------------------------------
# the port's callbacks and manager against the JAX package's
# ---------------------------------------------------------------------------

SEQUENCES = {
    # name: (test losses, config)
    "improve_then_plateau": ([5.0, 4.0, 3.0, 3.5, 3.6, 3.7, 3.8, 3.9, 4.0, 2.0, 2.5, 2.6, 2.7],
                             dict(checkpoint_freq=3, reduce_lr_on_plateau=True)),
    "noisy": ([9.0, 7.0, 8.0, 6.0, 6.0, 5.5, 7.0, 4.0, 4.5, 4.2, 3.9, 5.0],
              dict(checkpoint_freq=2, reduce_lr_on_plateau=True)),
    "no_improvement_saves": ([4.0, 3.0, 3.5, 2.0, 2.5, 1.0, 1.5, 1.2],
                             dict(checkpoint_freq=4, checkpoint_on_improvement=False)),
    "early_stop": ([3.0, 2.0, 2.5, 2.6, 2.7, 2.8],
                   dict(checkpoint_freq=10, max_early_stopping_index=2)),
}


def _on_disk(directory) -> list:
    return sorted(int(p) for p in os.listdir(directory) if p.isdigit())


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_callbacks_and_retention_match_jax(tmp_path, name):
    losses, kw = SEQUENCES[name]
    kw = dict(dict(end_epoch=len(losses), max_early_stopping_index=100), **kw)
    jcfg, cfg = JaxConfig(initial_learning_rate=1e-3, **kw), MopoeConfig(
        initial_learning_rate=1e-3, **kw)
    tx = jax_optimizer(jcfg)
    params = {"w": jnp.zeros((2,))}
    j_state = JaxState(params=params, batch_stats={}, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    j_mgr = JaxManager(str(tmp_path / "jax"))
    p_mgr = CheckpointManager(str(tmp_path / "port"))
    j_cb, p_cb = jax_callbacks.Callbacks(jcfg, j_mgr), Callbacks(cfg, p_mgr)
    p_state = tiny_state(lr=1e-3)
    for epoch, loss in enumerate(losses):
        j_stop, j_state = j_cb.update_epoch(epoch, loss, j_state)
        p_stop, p_state = p_cb.update_epoch(epoch, loss, p_state)
        j_mgr._queue.join()  # the JAX writer's queue drained: what is on its disk
        assert _on_disk(tmp_path / "port") == _on_disk(tmp_path / "jax"), epoch
        assert get_learning_rate(p_state) == pytest.approx(jax_lr(j_state), rel=1e-6), epoch
        assert p_stop == j_stop, epoch
        if p_stop:
            break
    assert p_mgr.all_epochs() == sorted(j_mgr.all_epochs())
    assert (p_mgr.best_epoch(), p_mgr.latest_epoch()) == (j_mgr.best_epoch(),
                                                          j_mgr.latest_epoch())
    j_mgr.close()


# ---------------------------------------------------------------------------
# restore in place
# ---------------------------------------------------------------------------

SMALL = dict(method="joint_elbo", dataset="testing", batch_size=4, class_dim=4, DIM_img=4,
             DIM_text=4, img_size=64, text_encoding="word", vocab_size=30,
             compute_dtype="float32", lr_warmup_steps=3)


def _tensors(state):
    opt = state.optimizer
    out = list(state.model.state_dict().values()) + [state.step_t]
    for g in opt.param_groups:
        out += [g["lr"], g["base_lr"]] + [t for p in g["params"] for t in opt.state[p].values()]
    return out


def test_restore_in_place_and_the_next_step_is_bitwise(tmp_path):
    cfg = MopoeConfig(**SMALL)
    step = make_train_step(cfg)
    batch = port_batch(numpy_batch(seed=2))
    state = create_train_state(cfg, device="cpu", seed=2)
    step(state, batch)  # Adam's state exists
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state, metrics={"test_loss": 1.0})
    torch.manual_seed(5)  # dropout's generator at the save
    mgr.save(1, state, force=True, metrics={"test_loss": 1.0})  # a forced save rewrites
    after = step(state, batch)
    ref = {k: v.clone() for k, v in state.model.state_dict().items()}

    held = _tensors(state)
    addresses = [t.data_ptr() for t in held]
    assert mgr.restore(state, epoch=1) == (1, state)
    assert [t.data_ptr() for t in _tensors(state)] == addresses  # the same tensors
    assert state.step == 1 and float(state.step_t) == 1.0
    for g in state.optimizer.param_groups:
        assert isinstance(g["lr"], torch.Tensor) and isinstance(g["base_lr"], torch.Tensor)
    again = step(state, batch)
    assert float(again["total_loss"]) == float(after["total_loss"])
    assert all(torch.equal(v, ref[k]) for k, v in state.model.state_dict().items())

    # into a fresh state, which has no Adam state yet: made on its device
    fresh = create_train_state(cfg, device="cpu", seed=9)
    mgr.restore(fresh, epoch=1)
    assert fresh.optimizer.state and all(
        isinstance(g["lr"], torch.Tensor) for g in fresh.optimizer.param_groups)
    step(fresh, batch)
    assert all(torch.equal(v, ref[k]) for k, v in fresh.model.state_dict().items())


def test_checkpoint_holds_the_whole_train_state(tmp_path):
    cfg = MopoeConfig(**SMALL)
    state = create_train_state(cfg, device="cpu", seed=3)
    no_dropout(state.model)
    make_train_step(cfg, eps=0.0)(state, port_batch(numpy_batch(seed=3)))
    CheckpointManager(str(tmp_path / "ck")).save(4, state, metrics={"test_loss": 2.5})
    payload = torch.load(tmp_path / "ck" / "4" / "state.pt", weights_only=True)
    assert set(payload) == {"model", "optimizer", "step", "step_t", "generator",
                            "default_generator", "epoch", "metrics"}
    assert payload["epoch"] == 4 and payload["metrics"] == {"test_loss": 2.5}
    assert payload["step"] == 1 and any(k.endswith("running_var") for k in payload["model"])
    assert len(payload["optimizer"]["state"]) == len(list(state.model.parameters()))
    assert torch.equal(payload["generator"], state.generator.get_state())
    assert all(np.isfinite(v.numpy()).all() for v in payload["model"].values())
