"""The port's training step (mopoe_mimic_tpu_torch/train) against the JAX
package's, float32 on the CPU, at small width (DIM 4, class_dim 4, 64 px,
vocab 30, batch 4).

The port's default init (seeded) goes to the JAX side through
``convert_mopoe_state_dict``. Random streams cannot match across the
frameworks, so both sides run with dropout off and z = mu: the JAX blocks'
``_dropout`` is the identity and ``mmvae.reparameterize`` returns mu (as
tests/test_golden_mmvae_core.py patches them); the port's dropout modules
have p = 0 and the step gets ``eps=0``. The JAX side is
``_forward_and_objective`` + ``value_and_grad`` + optax Adam, jitted once
per case (a module-scoped fixture), the port side ``make_train_step``.

The JAX BatchNorm computes the batch variance as E[x²] − μ² in float32
(resblocks.py:191-194). Against a float64 run of the port's step, that
form alone puts up to 4e-2 of a leaf's largest gradient into the JAX
gradients at this width (a cancellation where a channel's mean is large
against its spread), where the port's two-pass variance stays within
2e-5. The JAX side here therefore runs ``TwoPassBatchNorm``: the same
module with the variance taken as E[(x − μ)²], equal in exact arithmetic.

Tolerances: every loss term rtol 1e-4; gradients per leaf atol
1e-4·max|g| of that leaf plus float32 rounding of the model's largest
gradient (``test_gradients_match_jax``; JAX gradients map to the port's
names through ``state_dict_from_jax``, whose layout rules are linear); BN running
statistics as tests/test_torch_port_modules.py (rtol 1e-4, atol
1e-5·max(1, max|ref|)); a 3-step trajectory's total loss within 1e-3
relative.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import lax

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train.step import _forward_and_objective as jax_forward_and_objective
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.train.state import (
    create_train_state,
    get_learning_rate,
    set_learning_rate,
    warmup_factor,
)
from mopoe_mimic_tpu_torch.train.step import loss_terms as step_loss_terms
from mopoe_mimic_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_port_modules import assert_close

KW = dict(dataset="testing", batch_size=4, class_dim=4, DIM_img=4, DIM_text=4, img_size=64,
          text_encoding="word", vocab_size=30, compute_dtype="float32",
          initial_learning_rate=5e-4)
CASES = {
    "joint_elbo": dict(method="joint_elbo"),
    "poe": dict(method="poe"),
    "moe": dict(method="moe"),
    "jsd": dict(method="jsd"),
    "joint_elbo_fused": dict(method="joint_elbo", fused_text_head=True),
}
TRAJECTORY_STEPS = 3


class TwoPassBatchNorm(JR.TorchBatchNorm):
    """``TorchBatchNorm`` with the batch variance in two passes."""

    @nn.compact
    def __call__(self, x, use_running_average=None):
        ura = nn.merge_param("use_running_average", self.use_running_average,
                             use_running_average)
        feat = x.shape[-1]
        ra_mean = self.variable("batch_stats", "mean", lambda s: jnp.zeros(s, jnp.float32), (feat,))
        ra_var = self.variable("batch_stats", "var", lambda s: jnp.ones(s, jnp.float32), (feat,))
        scale = self.param("scale", nn.initializers.ones, (feat,), self.param_dtype)
        bias = self.param("bias", nn.initializers.zeros, (feat,), self.param_dtype)
        out_dtype = self.dtype or jnp.float32
        if ura:
            mean, var = ra_mean.value, ra_var.value
        else:
            xf = x.astype(jnp.float32).reshape(-1, feat)
            mean = jnp.mean(xf, axis=0)
            var = jnp.mean(jnp.square(xf - mean), axis=0)
            if not self.is_initializing():
                n = xf.shape[0]
                ra_mean.value = self.momentum * ra_mean.value + (1.0 - self.momentum) * mean
                ra_var.value = (self.momentum * ra_var.value
                                + (1.0 - self.momentum) * (var * (n / max(n - 1, 1))))
        inv = lax.rsqrt(var.astype(out_dtype) + jnp.asarray(self.epsilon, out_dtype))
        return ((x.astype(out_dtype) - mean.astype(out_dtype)) * (inv * scale.astype(out_dtype))
                + bias.astype(out_dtype))


def numpy_batch(seed=0, n=4):
    """JAX layout (NHWC images, [B, L] ids) from a numpy seed."""
    rng = np.random.default_rng(seed)
    return {"PA": rng.random((n, 64, 64, 1), dtype=np.float32),
            "Lateral": rng.random((n, 64, 64, 1), dtype=np.float32),
            "text": rng.integers(0, 30, (n, 128)).astype(np.int32)}


def port_batch(batch):
    return {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy() if v.ndim == 4 else v)
            for k, v in batch.items()}


def no_dropout(model):
    for mod in model.modules():
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
            mod.p = 0.0


def loss_terms(m):
    return {k: float(v) for k, v in step_loss_terms(m).items()}


def jax_run(case, sd, batch, steps, config=None):
    """JAX: ``steps`` Adam steps of the jitted objective, dropout off and
    z = mu. Returns per-step loss terms and, of the first step, the
    gradients and updated batch_stats as port state_dict entries.
    ``config``: the configuration's fields (default: KW with the case's)."""
    config = {**KW, **CASES[case]} if config is None else config
    jcfg = JaxConfig(**config)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    params, bstats = conv["params"], conv["batch_stats"]
    model = jax_mmvae.MMVae(jcfg)
    tx = optax.adam(jcfg.initial_learning_rate, b1=0.9, b2=0.999, eps=1e-8)
    opt_state = tx.init(params)
    rngs = {"dropout": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def step(params, bstats, opt_state):
        def loss_fn(p):
            total, new_bs, metrics = jax_forward_and_objective(jcfg, model, p, bstats, jbatch,
                                                               rngs, train=True)
            return total, (new_bs, metrics)

        (_, (new_bs, metrics)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, metrics, grads

    terms, first = [], None
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        for i in range(steps):
            new_params, bstats, opt_state, metrics, grads = step(params, bstats, opt_state)
            terms.append(loss_terms(jax.device_get(metrics)))
            if i == 0:
                pcfg = MopoeConfig(**config)
                g = state_dict_from_jax({"params": jax.device_get(grads)}, pcfg)
                stats = {k: v for k, v in state_dict_from_jax(
                    {"params": params, "batch_stats": jax.device_get(bstats)}, pcfg).items()
                    if k.endswith(("running_mean", "running_var"))}
                first = (g, stats)
            params = new_params
    return terms, first


def port_run(case, sd, batch, steps, config=None):
    cfg = MopoeConfig(**({**KW, **CASES[case]} if config is None else config))
    state = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(state.model)
    train_step = make_train_step(cfg, eps=0.0)
    terms, first = [], None
    for i in range(steps):
        m = train_step(state, port_batch(batch))
        terms.append(loss_terms(m))
        if i == 0:
            grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
            stats = {k: v.clone() for k, v in state.model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            first = (grads, stats, m)
    return terms, first, state


@pytest.fixture(scope="module")
def runs():
    """case → (JAX run, port run) from the same seeded weights and batch;
    the fused case runs the 3-step trajectory."""
    out = {}
    for i, case in enumerate(CASES):
        cfg = MopoeConfig(**KW, **CASES[case])
        sd = create_train_state(cfg, device="cpu", seed=i).model.state_dict()
        batch = numpy_batch(seed=i)
        steps = TRAJECTORY_STEPS if case == "joint_elbo_fused" else 1
        out[case] = (jax_run(case, sd, batch, steps), port_run(case, sd, batch, steps))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_terms_match_jax(runs, case):
    (j_terms, _), (p_terms, _, _) = runs[case]
    assert j_terms[0].keys() == p_terms[0].keys()
    for k, ref in j_terms[0].items():
        assert np.isfinite(ref), k
        np.testing.assert_allclose(p_terms[0][k], ref, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    """Per leaf |Δ| ≤ 1e-4·max|g_leaf| + 1e-7·g_max, g_max the model's
    largest gradient: the second term is float32 rounding of the largest
    gradient flows, which reaches leaves whose own gradient is small.
    Leaves whose gradient is zero in exact arithmetic (a bias in front of a
    train-mode BatchNorm, a shift into a shift-invariant block) hold
    rounding noise on both sides: where both are ≤ 1e-5·g_max they are held
    to that floor instead (float64 runs put those gradients below
    1e-13·g_max and every other leaf above 1.6e-5·g_max)."""
    (_, (j_grads, _)), (_, (p_grads, _, m), _) = runs[case]
    assert j_grads.keys() == p_grads.keys()
    g_max = max(float(g.abs().max()) for g in j_grads.values())
    tiny = 0
    for k, ref in j_grads.items():
        ref, got = ref.numpy(), p_grads[k].numpy()
        if max(np.abs(ref).max(), np.abs(got).max()) <= 1e-5 * g_max:
            tiny += 1
            continue
        atol = 1e-4 * float(np.abs(ref).max()) + 1e-7 * g_max
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=k)
    assert tiny < 0.2 * len(j_grads), tiny
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in j_grads.values()))
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bn_running_stats_match_jax(runs, case):
    """Under poe the unimodal forwards advance the statistics in call
    order, after the joint forward."""
    (_, (_, j_stats)), (_, (_, p_stats, _), _) = runs[case]
    assert j_stats.keys() == p_stats.keys() and j_stats
    for k in j_stats:
        assert_close(p_stats[k].numpy(), j_stats[k].numpy())


def test_fused_trajectory_matches_jax(runs):
    (j_terms, _), (p_terms, _, _) = runs["joint_elbo_fused"]
    assert len(j_terms) == len(p_terms) == TRAJECTORY_STEPS
    for i, (j, p) in enumerate(zip(j_terms, p_terms)):
        assert abs(p["total_loss"] - j["total_loss"]) < 1e-3 * abs(j["total_loss"]), (i, p, j)


def test_fused_and_unfused_port_steps_agree():
    """The port's fused head and its unfused decoder give the same step
    (as test_fused_head_train_step_matches_unfused does for JAX)."""
    batch = port_batch(numpy_batch(seed=7))
    sd = create_train_state(MopoeConfig(**KW), device="cpu", seed=7).model.state_dict()
    terms = {}
    for fused in (False, True):
        cfg = MopoeConfig(**KW, fused_text_head=fused)
        state = create_train_state(cfg, device="cpu", state_dict=sd)
        no_dropout(state.model)
        step = make_train_step(cfg, eps=0.0)
        terms[fused] = [loss_terms(step(state, batch)) for _ in range(2)]
        head = state.model.decoder("text").text_generator.generator[-1].weight
        assert not torch.equal(head, sd["decoder_text.text_generator.generator.6.weight"])
    for u, f in zip(terms[False], terms[True]):
        for k in u:
            np.testing.assert_allclose(f[k], u[k], rtol=1e-4, err_msg=k)


def test_optimizer_warmup_clipping_and_learning_rate():
    cfg = MopoeConfig(**KW, lr_warmup_steps=4, grad_clip_norm=1.0)
    assert [warmup_factor(cfg, s) for s in range(5)] == [0.25, 0.5, 0.75, 1.0, 1.0]
    state = create_train_state(cfg, device="cpu", seed=3)
    no_dropout(state.model)
    assert get_learning_rate(state) == pytest.approx(5e-4)
    m = make_train_step(cfg, eps=0.0)(state, port_batch(numpy_batch(seed=3)))
    assert state.step == 1 and float(m["grad_norm"]) > 1.0
    clipped = np.sqrt(sum(float((p.grad.double() ** 2).sum())
                          for p in state.model.parameters()))
    np.testing.assert_allclose(clipped, 1.0, rtol=1e-5)
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-4 * 0.25)
    set_learning_rate(state, 1e-4)
    assert get_learning_rate(state) == pytest.approx(1e-4)


def test_eval_step_uses_running_stats_and_keeps_train_mode():
    cfg = MopoeConfig(**KW)
    state = create_train_state(cfg, device="cpu", seed=4)
    batch = port_batch(numpy_batch(seed=4))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    m = make_eval_step(cfg, eps=0.0)(state, batch)
    assert np.isfinite(float(m["total_loss"])) and state.model.training
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_uint8_batch_is_dequantised():
    cfg = MopoeConfig(**KW)
    batch = port_batch(numpy_batch(seed=5))
    q = dict(batch, PA=(batch["PA"] * 255).round().to(torch.uint8))
    deq = dict(batch, PA=q["PA"].float() / 255.0)
    out = []
    for b in (q, deq):
        state = create_train_state(cfg, device="cpu", seed=5)
        no_dropout(state.model)
        out.append(loss_terms(make_train_step(cfg, eps=0.0)(state, b)))
    assert out[0] == out[1]


def test_chip_smoke_training_phase_rehearses_on_cpu():
    """chip_smoke.py's training phases (the driven steps and their checks,
    and the GPU-vs-CPU step's comparison) at this file's small width on
    the CPU, where the plain versions run and no kernel launches."""
    import chip_smoke

    cfg = MopoeConfig(**KW, fused_text_head=True)
    run = chip_smoke.drive_training(cfg, "cpu", kernels=(), warmup=1, steps=2)
    assert run["p50_ms"] > 0 and set(run["launches"]) == set(chip_smoke.KERNELS)
    sd = create_train_state(cfg, device="cpu", seed=0).model.state_dict()
    batch = chip_smoke.training_batch(cfg, 4, seed=14, device="cpu")
    terms, grads = chip_smoke.one_step_grads(cfg, sd, "cpu", batch)
    again, grads2 = chip_smoke.one_step_grads(cfg, sd, "cpu", batch)
    assert terms == again and all(torch.equal(grads[k], grads2[k]) for k in grads)
    params = create_train_state(cfg, device="cpu").model.named_parameters()
    assert set(grads) == {k for k, _ in params}
    # the float64 oracle step: the same step to float32's precision
    cfg64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
    terms64, grads64 = chip_smoke.one_step_grads(cfg64, sd, "cpu", batch)
    assert all(g.dtype == torch.float64 for g in grads64.values())
    for k in terms:
        np.testing.assert_allclose(terms[k], terms64[k], rtol=1e-5, err_msg=k)
