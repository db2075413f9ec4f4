"""The port's epoch runners (mopoe_mimic_tpu_torch/train/scan.py) against
the JAX package's ``make_train_epoch`` / ``make_eval_epoch``, and the
port's step bodies and tensor-lr Adam against the per-step path they
replace; float32 on the CPU at the small width of
tests/test_torch_port_train.py (DIM 4, class_dim 4, 64 px, vocab 30,
batch 4).

Both sides train on the same ``SyntheticMimic`` rows through their own
``DeviceStore`` and ``epoch_index_matrix`` (equal arrays:
tests/test_torch_port_data.py), from the same weights, with dropout off
and z = mu (the JAX side patched as in test_torch_port_train.py, on
``TwoPassBatchNorm``; the port with ``eps=0``), under the warmup ramp and
global-norm clipping (active at this init).

Tolerances: epoch means rtol 1e-4 (the loss terms' tolerance of
test_torch_port_train.py); parameters after the epoch as that file holds
gradients (``assert_params_close``; the BN running statistics after the
first step are held by test_bn_running_stats_match_jax, after three they
carry the drift of every activation); the eval epochs run from the same weights,
the port's after its train epoch. The port's per-step path against its
old form (Python-float lr, ``zero_grad(set_to_none=True)``, a
sum-of-squares norm): the same loss terms to float32 rounding (rtol 1e-6)
and parameters as against JAX.
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
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train import scan as jax_scan
from mopoe_mimic_tpu.train.state import TrainState as JaxState
from mopoe_mimic_tpu.train.state import make_optimizer as jax_optimizer
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.train.scan import (
    epoch_index_matrix,
    make_eval_epoch,
    make_train_epoch,
)
from mopoe_mimic_tpu_torch.train.state import (
    create_train_state,
    get_learning_rate,
    set_learning_rate,
    warmup_factor,
)
from mopoe_mimic_tpu_torch.train.step import (
    _autocast,
    _detach,
    _forward_and_objective,
    _to_device,
    loss_terms,
    make_eval_step,
    make_train_step,
)
from test_torch_port_train import KW, TwoPassBatchNorm, no_dropout

SCAN_KW = dict(KW, lr_warmup_steps=2, grad_clip_norm=1000.0)
STEPS, ROWS = 3, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: the suite's
    workers share the cores, and all-core parallel regions on ops this
    small wait on each other's descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def terms_of(means) -> dict:
    """The loss terms and grad_norm of an epoch-mean tree, as floats."""
    out = {k: means[k] for k in ("total_loss", "joint_divergence", "weighted_log_prob")}
    out.update({f"kld/{k}": v for k, v in means["klds"].items()})
    out.update({f"log_prob/{k}": v for k, v in means["log_probs"].items()})
    if "grad_norm" in means:
        out["grad_norm"] = means["grad_norm"]
    return {k: float(v) for k, v in out.items()}


def assert_params_close(got, ref, before, grads, steps, lr):
    """Parameters after an epoch held as test_gradients_match_jax holds
    gradients: per leaf |Δ| ≤ 1e-4·max|p_leaf| + 1e-7·p_max, p_max the
    model's largest parameter. A leaf whose gradient is zero in exact
    arithmetic (a bias in front of a train-mode BatchNorm) holds rounding
    noise, which Adam turns into steps of ±lr that differ between any two
    runs: where the last step's gradient ``grads`` of a leaf is all below
    1e-5 of the model's largest, as the gradient test's floor, its change
    from ``before`` is held to Adam's reach, 2·steps·lr, on both sides
    instead. Fewer than a fifth of the leaves may be such."""
    keys = list(grads)
    g_max = max(float(g.abs().max()) for g in grads.values())
    p_max = max(float(ref[k].abs().max()) for k in keys)
    noise = [k for k in keys if float(grads[k].abs().max()) <= 1e-5 * g_max]
    assert len(noise) < 0.2 * len(keys), noise
    for k in keys:
        if k in noise:
            moved = max(float((t[k] - before[k]).abs().max()) for t in (got, ref))
            assert moved <= 2 * steps * lr, (k, moved)
            continue
        atol = 1e-4 * float(ref[k].abs().max()) + 1e-7 * p_max
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=0, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# the epoch runners against JAX
# ---------------------------------------------------------------------------

def jax_epochs(before, after, train_idx, eval_idx):
    """JAX, dropout off and z = mu: ``make_train_epoch`` over ``train_idx``
    from the weights ``before``, and ``make_eval_epoch`` over ``eval_idx``
    from the port's weights ``after`` its own train epoch (the eval runner
    held apart from the drift of training). Returns (train means, eval
    means, parameters and BN statistics after the train epoch, as port
    state_dict entries)."""
    jcfg = JaxConfig(**SCAN_KW)
    model = jax_mmvae.MMVae(jcfg)
    tx = jax_optimizer(jcfg)

    def state_of(sd):
        conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
        return JaxState(params=conv["params"], batch_stats=conv["batch_stats"],
                        opt_state=tx.init(conv["params"]), step=jnp.zeros((), jnp.int32),
                        rng=jax.random.PRNGKey(0))

    store = JaxStore(JaxSynthetic(jcfg, seed=0, length=ROWS), jcfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        state, train = jax_scan.make_train_epoch(jcfg, store, model, tx)(
            state_of(before), store.cols, jnp.asarray(train_idx))
        _, evals = jax_scan.make_eval_epoch(jcfg, store, model)(
            state_of(after), jax.random.PRNGKey(7), store.cols, jnp.asarray(eval_idx))
    trained = state_dict_from_jax(jax.device_get({"params": state.params,
                                                  "batch_stats": state.batch_stats}),
                                  MopoeConfig(**SCAN_KW))
    return jax.device_get(train), jax.device_get(evals), trained


@pytest.fixture(scope="module")
def epochs():
    cfg = MopoeConfig(**SCAN_KW)
    store = DeviceStore(SyntheticMimic(cfg, seed=0, length=ROWS), cfg, device="cpu")
    train_idx = epoch_index_matrix(store, 0, cfg.batch_size, steps_cap=STEPS)
    eval_idx = epoch_index_matrix(store, 1, cfg.batch_size, seed=1, steps_cap=STEPS)
    state = create_train_state(cfg, device="cpu", seed=11)
    no_dropout(state.model)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    _, train = make_train_epoch(cfg, store, eps=0.0)(state, train_idx)
    _, evals = make_eval_epoch(cfg, store, eps=0.0)(state, torch.Generator().manual_seed(7),
                                                     eval_idx)
    after = {k: v.clone() for k, v in state.model.state_dict().items()}
    return {"port": (train, evals, after), "jax": jax_epochs(before, after, train_idx, eval_idx),
            "before": before, "state": state, "cfg": cfg}


@pytest.mark.parametrize("which", [0, 1], ids=["train", "eval"])
def test_epoch_means_match_jax(epochs, which):
    got, ref = terms_of(epochs["port"][which]), terms_of(epochs["jax"][which])
    assert got.keys() == ref.keys() and ("grad_norm" in got) == (which == 0)
    for k, v in ref.items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
    assert epochs["port"][which]["nan_in_latents"] == 0.0


def test_train_epoch_parameters_match_jax(epochs):
    got, ref, before = epochs["port"][2], epochs["jax"][2], epochs["before"]
    grads = {k: p.grad for k, p in epochs["state"].model.named_parameters()}
    assert_params_close(got, ref, before, grads, STEPS, epochs["cfg"].initial_learning_rate)


def test_train_epoch_advances_the_step_counts(epochs):
    state = epochs["state"]
    assert state.step == STEPS and float(state.step_t) == STEPS
    cfg = epochs["cfg"]
    lr = state.optimizer.param_groups[0]["lr"]
    np.testing.assert_allclose(float(lr), 5e-4 * warmup_factor(cfg, STEPS - 1), rtol=1e-6)


# ---------------------------------------------------------------------------
# the step bodies and the tensor-lr Adam against the per-step path they replace
# ---------------------------------------------------------------------------

def old_train_step(cfg, eps):
    """The per-step path before the step bodies: ``zero_grad(set_to_none)``,
    missing gradients filled on the host, a sum-of-squares global norm, a
    Python-float learning rate (``base_lr`` × ``warmup_factor`` of the host
    step) and a non-capturable Adam."""
    clip = float(cfg.grad_clip_norm)

    def step(model, opt, generator, host, batch):
        batch = _to_device(batch, next(model.parameters()))
        model.train()
        opt.zero_grad(set_to_none=True)
        with _autocast(cfg, torch.device("cpu")):
            total, metrics = _forward_and_objective(cfg, model, batch, generator, eps)
        total.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        grad_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if clip > 0:
            scale = torch.where(grad_norm < clip, torch.ones_like(grad_norm), clip / grad_norm)
            torch._foreach_mul_(grads, scale)
        for group in opt.param_groups:
            group["lr"] = host["base_lr"] * warmup_factor(cfg, host["step"])
        opt.step()
        host["step"] += 1
        metrics = _detach(metrics)
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return step


@pytest.mark.parametrize("runner", ["step", "epoch"])
def test_step_body_matches_the_old_per_step_path(runner):
    """Two epochs of two steps each, the learning rate set between them
    (the plateau callback), under the warmup ramp and clipping: the port's
    per-step path (``make_train_step``) and its epoch runner against the
    old per-step path."""
    cfg = MopoeConfig(**dict(SCAN_KW, lr_warmup_steps=3))
    store = DeviceStore(SyntheticMimic(cfg, seed=2, length=ROWS), cfg, device="cpu")
    sd = create_train_state(cfg, device="cpu", seed=12).model.state_dict()
    old = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(old.model)
    old_opt = torch.optim.Adam(old.model.parameters(), lr=cfg.initial_learning_rate,
                               betas=(cfg.beta_1, cfg.beta_2), eps=1e-8)
    host = {"base_lr": cfg.initial_learning_rate, "step": 0}
    old_step = old_train_step(cfg, eps=0.0)
    new = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(new.model)
    train_step, train_epoch = make_train_step(cfg, eps=0.0), make_train_epoch(cfg, store, eps=0.0)
    for epoch, lr in ((0, None), (1, 2e-4)):
        if lr is not None:
            host["base_lr"] = lr
            set_learning_rate(new, lr)
            assert get_learning_rate(new) == pytest.approx(lr)
        idx = epoch_index_matrix(store, epoch, cfg.batch_size, steps_cap=2)
        ref = [loss_terms(old_step(old.model, old_opt, old.generator, host, store.gather(row)))
               for row in idx]
        if runner == "step":
            got = [loss_terms(train_step(new, store.gather(row))) for row in idx]
            for g, r in zip(got, ref):
                for k in r:
                    np.testing.assert_allclose(float(g[k]), float(r[k]), rtol=1e-6, err_msg=k)
        else:
            _, means = train_epoch(new, idx)
            got = terms_of(means)
            for k in got:
                if k != "grad_norm":
                    mean = np.mean([float(r[k]) for r in ref])
                    np.testing.assert_allclose(got[k], mean, rtol=1e-6, err_msg=k)
        assert new.step == host["step"] == 2 * (epoch + 1)
        lr_ref = host["base_lr"] * warmup_factor(cfg, host["step"] - 1)
        np.testing.assert_allclose(float(new.optimizer.param_groups[0]["lr"]), lr_ref, rtol=1e-6)
    grads = {k: p.grad for k, p in new.model.named_parameters()}
    assert_params_close(new.model.state_dict(), old.model.state_dict(), sd, grads, 4,
                        cfg.initial_learning_rate)


def test_eval_epoch_matches_per_step_eval_and_advances_the_generator():
    """The eval epoch equals the per-step eval loop over the same rows, and
    hands back the generator where the loop leaves it (noise drawn)."""
    cfg = MopoeConfig(**SCAN_KW)
    store = DeviceStore(SyntheticMimic(cfg, seed=3, length=ROWS), cfg, device="cpu")
    state = create_train_state(cfg, device="cpu", seed=13)
    idx = epoch_index_matrix(store, 0, cfg.batch_size)
    g_loop, g_epoch = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    eval_step = make_eval_step(cfg)
    loop = [terms_of(eval_step(state, store.gather(row), g_loop)) for row in idx]
    out, means = make_eval_epoch(cfg, store)(state, g_epoch, idx)
    assert out is g_epoch and torch.equal(g_epoch.get_state(), g_loop.get_state())
    assert not torch.equal(g_epoch.get_state(), torch.Generator().manual_seed(5).get_state())
    for k, v in terms_of(means).items():
        np.testing.assert_allclose(v, np.mean([t[k] for t in loop]), rtol=1e-6, err_msg=k)


def test_the_capture_puts_back_what_its_warm_up_changed():
    """The state a capture's warm-up leaves is put back in place: the
    parameters, BN statistics, step count and generator as they were, and
    the optimizer state the warm-up made zeroed, so the next step is the
    first step of a fresh state, bit for bit."""
    from mopoe_mimic_tpu_torch.train.scan import _train_snapshot, _train_tensors
    from mopoe_mimic_tpu_torch.train.step import make_train_step_body, static_grads

    cfg = MopoeConfig(**SCAN_KW)
    store = DeviceStore(SyntheticMimic(cfg, seed=4, length=ROWS), cfg, device="cpu")
    sd = create_train_state(cfg, device="cpu", seed=14).model.state_dict()
    warmed, fresh = (create_train_state(cfg, device="cpu", state_dict=sd, seed=1)
                     for _ in range(2))
    batch = store.gather(np.arange(4))
    static_grads(list(warmed.model.parameters()))
    addresses = [t.data_ptr() for t in _train_tensors(warmed) if t is not None]
    restore = _train_snapshot(warmed)
    body = make_train_step_body(cfg)
    for _ in range(2):
        body(warmed, batch)
    moved = [t.data_ptr() for t in _train_tensors(warmed)]
    restore()
    assert [t.data_ptr() for t in _train_tensors(warmed)] == moved  # in place
    assert set(addresses) <= set(moved)  # the warm-up only added tensors
    assert float(warmed.step_t) == 0.0
    assert torch.equal(warmed.generator.get_state(), fresh.generator.get_state())
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(warmed.model.state_dict()[k], v), k
    for p in warmed.model.parameters():
        assert all(not t.any() for t in warmed.optimizer.state[p].values())
    torch.manual_seed(0)
    a = loss_terms(make_train_step(cfg)(warmed, batch))
    torch.manual_seed(0)
    b = loss_terms(make_train_step(cfg)(fresh, batch))
    assert all(torch.equal(a[k], b[k]) for k in a)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(warmed.model.state_dict()[k], v), k


@pytest.mark.parametrize("name", ["laplace", "normal"])
def test_log_probs_take_their_scale_as_a_float(name, monkeypatch):
    """The image likelihoods build no tensor from their scale (on the card
    that was a copy from the host in every step, which a CUDA graph cannot
    hold) and give the values of the tensor-scale form they replace."""
    from mopoe_mimic_tpu_torch.ops import distributions as D

    rng = np.random.default_rng(0)
    x, loc = (torch.from_numpy(rng.random((4, 1, 8, 8), dtype=np.float32)) for _ in range(2))
    scale = torch.as_tensor(0.75, dtype=x.dtype)
    if name == "laplace":
        old = -torch.log(2.0 * scale) - torch.abs(x - loc) / scale
    else:
        old = -((x - loc) ** 2) / (2.0 * scale * scale) - torch.log(scale) - D._HALF_LOG_2PI

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor built from the scale")

    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    got = getattr(D, f"{name}_log_prob")(x, loc, 0.75)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), old.numpy(), rtol=1e-6)


def test_index_matrix_must_have_rows():
    cfg = MopoeConfig(**SCAN_KW)
    store = DeviceStore(SyntheticMimic(cfg, seed=0, length=ROWS), cfg, device="cpu")
    state = create_train_state(cfg, device="cpu", seed=0)
    with pytest.raises(ValueError):
        make_train_epoch(cfg, store)(state, np.zeros((0, 4), np.int32))


def test_chip_smoke_epoch_phase_rehearses_on_cpu():
    """chip_smoke.py's phase 9 on the CPU at this file's small width: the
    store and its gather's check, and the graphed-against-eager parity
    (here the CPU's plain loop against the eager steps, so bitwise equal);
    its training-A part needs the card."""
    import chip_smoke

    cfg = MopoeConfig(**KW, fused_text_head=True, lr_warmup_steps=300)
    out = chip_smoke.drive_epoch(cfg, "cpu", kernels=(), rows=64)
    assert out["store"]["bytes"] == 64 * (2 * 64 * 64 + 4 * 128)
    assert out["parity"]["bitwise"] and out["parity"]["steps"] == 8
    assert "training_a" not in out
