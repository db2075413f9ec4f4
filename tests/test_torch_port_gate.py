"""The training slice's parity gate: 8 Adam steps at the flagship's shapes,
the port against the JAX package, float32 on the CPU.

Shapes as tests/test_golden_mmvae_core.py's flagship trajectory (128 px,
DIM 64, class_dim 64, batch 8, vocab 500, lr 5e-4, joint_elbo), with
dropout off and z = mu (the JAX side patched as in
tests/test_torch_port_train.py, on its two-pass BatchNorm variance; the
port with ``eps=0``). Both sides train on the same ``SyntheticMimic`` rows
through their own ``DeviceStore`` and epoch runner (``make_train_epoch``,
one row an epoch, so every step's loss is read), from the same seeded
weights, then run their eval epoch on a held-out batch in eval mode (BN
running statistics).

Pass, as the golden test: the total loss's drift |port − jax| /
max(1, |jax|) below 2e-3 at the first step and 1e-2 at every step, and
the eval-mode loss after 8 steps within 2e-2
(tests/test_golden_mmvae_core.py:1066-1067).

Marked ``slow``: the JAX side's train step takes ~15 s on the CPU at these
shapes, ~160 s for the gate in all (the port's side ~6 s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.data.device_store import DeviceStore as JaxStore
from mopoe_mimic_tpu.data.synthetic import SyntheticMimic as JaxSynthetic
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models.mmvae import MMVae as JaxMMVae
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train import scan as jax_scan
from mopoe_mimic_tpu.train.state import TrainState as JaxState
from mopoe_mimic_tpu.train.state import make_optimizer as jax_optimizer
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.train.scan import (
    epoch_index_matrix,
    make_eval_epoch,
    make_train_epoch,
)
from mopoe_mimic_tpu_torch.train.state import create_train_state
from test_torch_port_train import TwoPassBatchNorm, no_dropout

STEPS, BATCH = 8, 8
W = 1.0 / 3.0
GATE = dict(method="joint_elbo", dataset="testing", img_size=128, DIM_img=64, DIM_text=64,
            class_dim=64, text_encoding="word", vocab_size=500, batch_size=BATCH,
            compute_dtype="float32", initial_learning_rate=5e-4, beta=1.0, beta_style=1.0,
            beta_content=1.0, rec_weight_m1=W, rec_weight_m2=W, rec_weight_m3=W)
ROWS = STEPS * BATCH


def jax_trajectory(sd, train_idx, eval_idx):
    """JAX: one ``make_train_epoch`` call per row of ``train_idx``, then
    ``make_eval_epoch`` over ``eval_idx``; (total loss a step, eval loss)."""
    jcfg = JaxConfig(**GATE)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    model, tx = JaxMMVae(jcfg), jax_optimizer(jcfg)
    state = JaxState(params=conv["params"], batch_stats=conv["batch_stats"],
                     opt_state=tx.init(conv["params"]), step=jnp.zeros((), jnp.int32),
                     rng=jax.random.PRNGKey(0))
    store = JaxStore(JaxSynthetic(jcfg, seed=0, length=ROWS), jcfg)
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        train_epoch = jax_scan.make_train_epoch(jcfg, store, model, tx)
        for row in train_idx:
            state, means = train_epoch(state, store.cols, jnp.asarray(row[None]))
            losses.append(float(means["total_loss"]))
        _, means = jax_scan.make_eval_epoch(jcfg, store, model)(
            state, jax.random.PRNGKey(7), store.cols, jnp.asarray(eval_idx))
    return np.asarray(losses), float(means["total_loss"])


def port_trajectory(sd, train_idx, eval_idx):
    cfg = MopoeConfig(**GATE)
    store = DeviceStore(SyntheticMimic(cfg, seed=0, length=ROWS), cfg, device="cpu")
    state = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(state.model)
    train_epoch = make_train_epoch(cfg, store, eps=0.0)
    losses = [train_epoch(state, row[None])[1]["total_loss"] for row in train_idx]
    _, means = make_eval_epoch(cfg, store, eps=0.0)(state, torch.Generator().manual_seed(7),
                                                     eval_idx)
    return np.asarray(losses), means["total_loss"]


@pytest.mark.slow
def test_eight_flagship_steps_match_jax():
    cfg = MopoeConfig(**GATE)
    order = DeviceStore(SyntheticMimic(cfg, seed=0, length=ROWS), cfg, device="cpu")
    train_idx = epoch_index_matrix(order, 0, BATCH)
    eval_idx = epoch_index_matrix(order, 1, BATCH, seed=1, steps_cap=1)
    assert train_idx.shape == (STEPS, BATCH)
    sd = create_train_state(cfg, device="cpu", seed=0).model.state_dict()
    port, port_eval = port_trajectory(sd, train_idx, eval_idx)
    ref, ref_eval = jax_trajectory(sd, train_idx, eval_idx)
    assert np.isfinite(ref).all() and np.isfinite(ref_eval)
    rel = np.abs(port - ref) / np.maximum(1.0, np.abs(ref))
    rel_eval = abs(port_eval - ref_eval) / max(1.0, abs(ref_eval))
    print(f"\nflagship shapes, port vs JAX: step rel drift {np.array2string(rel, precision=2)}; "
          f"eval {port_eval:.2f} vs {ref_eval:.2f} rel {rel_eval:.2e}")
    assert rel[0] < 2e-3, rel[0]
    assert rel.max() < 1e-2, (rel.argmax(), rel.max())
    assert rel_eval < 2e-2, (port_eval, ref_eval)
