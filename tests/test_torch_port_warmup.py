"""lr warmup and the early divergence at lr 5e-4, on the port, against the
JAX package (docs/STABILITY.md; tests/test_warmup_stability.py).

* tests/test_warmup_stability.py ported unchanged: batch 16, float32,
  64 px, DIM 64, word vocab 100, lr 5e-4, 30 steps on the noise fixture,
  warmup 0 against warmup 100, from the JAX test's initial weights (its
  ``create_train_state`` at PRNGKey(0), carried over by
  ``state_dict_from_jax``), dropout drawn from the default generator
  seeded as ``Experiment.init_state`` seeds it. The port diverges without
  the warmup and trains with it, as the JAX test asserts. Marked
  ``slow``, as the JAX test is. (From the port's own init, PyTorch's,
  which the JAX package's ``torch_init=True`` emulates, the run without
  warmup spikes but need not reach NaN within 30 steps: the sure
  divergence belongs to the JAX default init, he_normal.)
* The port's per-step total loss against JAX's over the same steps, from
  the same weights and batches, dropout off and z = mu (the JAX side on
  its two-pass BatchNorm variance, as tests/test_torch_port_gate.py sets
  both sides up): where JAX is finite, |port − jax| / max(1, |jax|) ≤ 1e-2
  through step 8 (the gate's bound); the first non-finite step within ±2
  of JAX's (or neither side's loss non-finite); under warmup 100 both
  finite at every step. 30 steps at DIM 64 are ``slow`` (the JAX side's
  steps); the fast lane holds the same checks at DIM 8 over 10 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.data.loader import BatchLoader as JaxLoader
from mopoe_mimic_tpu.data.synthetic import SyntheticMimic as JaxSynthetic
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train.state import create_train_state as jax_train_state
from mopoe_mimic_tpu.train.state import make_optimizer as jax_optimizer
from mopoe_mimic_tpu.train.step import _forward_and_objective as jax_forward_and_objective
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.loader import BatchLoader
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.experiment import DROPOUT_SEED_OFFSET
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import make_train_step
from test_torch_port_train import TwoPassBatchNorm, no_dropout, port_batch

GATE_STEPS, DRIFT = 8, 1e-2  # the 8-step gate's steps and bound


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models (as
    tests/test_torch_port_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(warmup_steps: int, dim: int = 64) -> dict:
    return dict(method="joint_elbo", dataset="testing", img_size=64, DIM_img=dim, DIM_text=dim,
                class_dim=dim, text_encoding="word", vocab_size=100, batch_size=16,
                compute_dtype="float32",
                initial_learning_rate=5e-4,  # the reference's canonical lr
                lr_warmup_steps=warmup_steps, seed=0)


def jax_initial_weights(kw: dict) -> dict:
    """The JAX stability test's initial weights as the port's state_dict."""
    jcfg = JaxConfig(**kw)
    ds = JaxSynthetic(jcfg, seed=0, length=4 * jcfg.batch_size)
    batch = next(iter(JaxLoader(ds, jcfg.batch_size, shuffle=False)))[0]
    state = jax_train_state(jcfg, jax.random.PRNGKey(0), batch)
    return state_dict_from_jax({"params": jax.device_get(state.params),
                                "batch_stats": jax.device_get(state.batch_stats)},
                               MopoeConfig(**kw))


def _losses(warmup_steps: int, steps: int = 30):
    """tests/test_warmup_stability.py's run on the port."""
    cfg = MopoeConfig(**_kw(warmup_steps))
    ds = SyntheticMimic(cfg, seed=0, length=4 * cfg.batch_size)
    batches = [b for b, _ in BatchLoader(ds, cfg.batch_size, shuffle=False)]
    state = create_train_state(cfg, device="cpu",
                               state_dict=jax_initial_weights(_kw(warmup_steps)))
    torch.manual_seed(cfg.seed + DROPOUT_SEED_OFFSET)  # dropout's draws
    step = make_train_step(cfg)
    losses = []
    for i in range(steps):
        m = step(state, batches[i % len(batches)])
        losses.append(float(m["total_loss"]))
        if not np.isfinite(losses[-1]):
            break
    return np.asarray(losses)


@pytest.mark.slow
def test_lr5e4_diverges_without_warmup_and_trains_with_it():
    bare = _losses(warmup_steps=0)
    assert not np.isfinite(bare).all(), (
        "expected the documented lr-5e-4 divergence on the noise fixture "
        "(docs/STABILITY.md) — did the architecture change?"
    )
    warm = _losses(warmup_steps=100)
    assert np.isfinite(warm).all(), warm
    assert warm[-1] < warm[0], warm  # and it actually trains


# ---------------------------------------------------------------------------
# the port's trajectory against JAX's
# ---------------------------------------------------------------------------

def _fixture_batches(cfg) -> list:
    """The noise fixture's 4 batches in the JAX layout (NHWC images)."""
    arrays = SyntheticMimic(cfg, seed=0, length=4 * cfg.batch_size).arrays
    b = cfg.batch_size
    return [{k: v[i * b:(i + 1) * b] for k, v in arrays.items()} for i in range(4)]


def _until_nonfinite(step, steps: int) -> list:
    losses = []
    for i in range(steps):
        losses.append(step(i))
        if not np.isfinite(losses[-1]):
            break
    return losses


def port_trajectory(kw: dict, sd, batches, steps: int) -> list:
    cfg = MopoeConfig(**kw)
    state = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(state.model)
    train_step = make_train_step(cfg, eps=0.0)
    port = [port_batch(b) for b in batches]
    return _until_nonfinite(
        lambda i: float(train_step(state, port[i % len(port)])["total_loss"]), steps)


def jax_trajectory(kw: dict, sd, batches, steps: int) -> list:
    """JAX: its optimizer (Adam with the warmup ramp) on the jitted
    objective, dropout off, z = mu, two-pass BatchNorm variance."""
    jcfg = JaxConfig(**kw)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    model, tx = jax_mmvae.MMVae(jcfg), jax_optimizer(jcfg)
    rngs = {"dropout": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}
    carry = {"params": conv["params"], "stats": conv["batch_stats"],
             "opt": tx.init(conv["params"])}

    @jax.jit
    def step(params, stats, opt, batch):
        def loss_fn(p):
            total, new_bs, _ = jax_forward_and_objective(jcfg, model, p, stats, batch, rngs,
                                                         train=True)
            return total, new_bs

        (total, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, total

    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]

    def one(i):
        params, carry["stats"], carry["opt"], total = step(
            carry["params"], carry["stats"], carry["opt"], jbatches[i % len(jbatches)])
        carry["params"] = params
        return float(total)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        return _until_nonfinite(one, steps)


def _first_nonfinite(losses):
    bad = [i for i, v in enumerate(losses) if not np.isfinite(v)]
    return bad[0] if bad else None


def compare(warmup: int, dim: int, steps: int):
    kw = _kw(warmup, dim)
    sd = create_train_state(MopoeConfig(**kw), device="cpu", seed=0).model.state_dict()
    batches = _fixture_batches(MopoeConfig(**kw))
    ref = jax_trajectory(kw, sd, batches, steps)
    got = port_trajectory(kw, sd, batches, steps)
    for i, (g, r) in enumerate(zip(got[:GATE_STEPS], ref[:GATE_STEPS])):
        if np.isfinite(r):
            assert abs(g - r) / max(1.0, abs(r)) <= DRIFT, (i, g, r)
    j_bad, p_bad = _first_nonfinite(ref), _first_nonfinite(got)
    if warmup:
        assert j_bad is None and p_bad is None and len(got) == len(ref) == steps, (got, ref)
    else:
        assert (j_bad is None) == (p_bad is None), (got, ref)
        assert j_bad is None or abs(p_bad - j_bad) <= 2, (p_bad, j_bad)
    return got, ref


@pytest.mark.parametrize("warmup", [0, 100])
def test_trajectory_matches_jax_fast(warmup):
    """DIM 8, 10 steps: the fast lane's case of the comparison."""
    compare(warmup, dim=8, steps=10)


@pytest.mark.slow
@pytest.mark.parametrize("warmup", [0, 100])
def test_trajectory_matches_jax(warmup):
    """The stability test's setup, 30 steps."""
    compare(warmup, dim=64, steps=30)


def main() -> None:
    """Print the comparison's numbers at the stability test's setup (DIM
    64, 30 steps), from the port's init and from the JAX test's, each
    warmup, and the port's stability runs (dropout on) from both inits:
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_warmup.py`` (~10 min
    on the CPU)."""
    import json

    out = {}
    for init in ("port", "jax"):
        for warmup in (0, 100):
            kw = _kw(warmup)
            sd = (jax_initial_weights(kw) if init == "jax" else
                  create_train_state(MopoeConfig(**kw), device="cpu", seed=0).model.state_dict())
            batches = _fixture_batches(MopoeConfig(**kw))
            ref, got = jax_trajectory(kw, sd, batches, 30), port_trajectory(kw, sd, batches, 30)
            both = [(g, r) for g, r in zip(got, ref) if np.isfinite(g) and np.isfinite(r)]
            out[f"{init} init, warmup {warmup}"] = {
                "steps": [len(ref), len(got)], "first_nonfinite": [_first_nonfinite(ref),
                                                                  _first_nonfinite(got)],
                "max_rel": max(abs(g - r) / max(1.0, abs(r)) for g, r in both),
                "first_last": [ref[0], ref[-1], got[0], got[-1]]}
            print(json.dumps({k: out[k] for k in [f"{init} init, warmup {warmup}"]}), flush=True)
    print(json.dumps({"stability, JAX init": {w: _losses(w).tolist() for w in (0, 100)}}))
    for seed in range(4):  # the port's own init, dropout from four seeds
        cfg = MopoeConfig(**_kw(0))
        ds = SyntheticMimic(cfg, seed=0, length=4 * cfg.batch_size)
        batches = [b for b, _ in BatchLoader(ds, cfg.batch_size, shuffle=False)]
        state = create_train_state(cfg, device="cpu", seed=0)
        torch.manual_seed(seed)
        step = make_train_step(cfg)
        losses = _until_nonfinite(lambda i: float(step(state, batches[i % 4])["total_loss"]), 30)
        print(json.dumps({f"stability, port init, no warmup, dropout seed {seed}":
                          {"first_nonfinite": _first_nonfinite(losses), "max": max(losses)}}),
              flush=True)


if __name__ == "__main__":
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)

    torch.set_num_threads(1)
    main()
