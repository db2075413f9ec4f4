"""``bn_compute_dtype`` in the port (mopoe_mimic_tpu_torch/models/resblocks.py,
img_networks.py, text_networks.py, mmvae.py) on the CPU, at small width
(DIM 4, class_dim 4, 64 px, vocab 30, batch 4).

* Under ``compute_dtype="float32"``, ``"compute"`` is ``"float32"``, bit for
  bit: two train steps and an eval step, with and without
  ``fused_pointwise``.
* The dtype's resolution (mmvae.py:60 of the JAX package) and where it
  applies: each BatchNorm takes and gives that dtype under bfloat16
  autocast, its running statistics and its weight's gradient stay float32.
* Against the JAX package under ``compute_dtype="bfloat16"``: the image
  and word encoders in train mode (JAX's ``bn_dtype=bfloat16``), each
  output within 3e-2·max|ref| (bfloat16 rounding through up to seven
  layers: PyTorch's BatchNorm normalizes in float32 and rounds once, JAX
  rounds after each bfloat16 operation); and 2 train steps on carried
  weights for ``"compute"``, ``"bfloat16"`` and ``"compute"`` with
  ``fused_pointwise`` (K3's plain versions, then on bfloat16 x), the JAX
  side patched as tests/test_torch_port_train.py patches it (two-pass BN,
  no dropout, z = mu): the total loss within 2e-2 relative at each step,
  every gradient finite, the running statistics float32.
* The channels-last model (bfloat16 BatchNorms) against the NCHW one: the
  same keys and values from the JAX package's variables through
  ``jax_import`` and after a checkpoint's round trip between the layouts,
  Adam's states in the loading parameters' layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.models import img_networks as JI
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models import text_networks as JT
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.train.step import _forward_and_objective as jax_forward_and_objective
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models import img_networks as TI
from mopoe_mimic_tpu_torch.models import text_networks as TT
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.models.resblocks import _ResidualBlock, bn_dtype_of
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import loss_terms, make_eval_step, make_train_step
from test_torch_port_modules import noisy, port_weights
from test_torch_port_pointwise import two_pass_fused_bn_relu_pointwise
from test_torch_port_train import TwoPassBatchNorm, no_dropout, numpy_batch, port_batch

KW = dict(method="joint_elbo", dataset="testing", batch_size=4, class_dim=4, DIM_img=4,
          DIM_text=4, img_size=64, text_encoding="word", vocab_size=30,
          initial_learning_rate=5e-4, fused_text_head=True)
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models: the suite's
    workers share the cores, and all-core parallel regions on ops this
    small wait on each other's descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bn_modules(model):
    return [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused_pointwise"])
def test_compute_is_float32_bitwise_under_float32(fused):
    batch = port_batch(numpy_batch(seed=1))
    sd = create_train_state(MopoeConfig(**KW, compute_dtype="float32"), device="cpu",
                            seed=1).model.state_dict()
    runs = {}
    for bn in ("float32", "compute"):
        cfg = MopoeConfig(**KW, compute_dtype="float32", bn_compute_dtype=bn,
                          fused_pointwise=fused)
        state = create_train_state(cfg, device="cpu", state_dict=sd)
        no_dropout(state.model)
        step = make_train_step(cfg, eps=0.0)
        terms = [{k: float(v) for k, v in loss_terms(step(state, batch)).items()}
                 for _ in range(STEPS)]
        grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
        evals = float(make_eval_step(cfg, eps=0.0)(state, batch)["total_loss"])
        runs[bn] = terms, grads, state.model.state_dict(), evals
    (t32, g32, s32, e32), (tc, gc, sc, ec) = runs["float32"], runs["compute"]
    assert t32 == tc and e32 == ec
    assert all(torch.equal(g32[k], gc[k]) for k in g32)
    assert all(torch.equal(s32[k], sc[k]) for k in s32)


@pytest.mark.parametrize("bn,compute,expected", [
    ("float32", "bfloat16", torch.float32), ("compute", "bfloat16", torch.bfloat16),
    ("compute", "float32", torch.float32), ("compute", "float64", torch.float64),
    ("bfloat16", "float32", torch.bfloat16), ("float16", "bfloat16", torch.float16)])
def test_bn_dtype_resolution(bn, compute, expected):
    cfg = MopoeConfig(**KW, compute_dtype=compute, bn_compute_dtype=bn)
    assert bn_dtype_of(cfg) == expected
    blocks = [m for m in MMVae(cfg).modules() if isinstance(m, _ResidualBlock)]
    assert blocks and all(b.bn_dtype == expected for b in blocks)


def test_unknown_bn_dtype_raises():
    with pytest.raises(ValueError, match="bn_compute_dtype"):
        MMVae(MopoeConfig(**KW, bn_compute_dtype="int8"))


@pytest.mark.parametrize("fused", [False, True], ids=["modules", "fused_pointwise"])
def test_batchnorm_runs_in_bfloat16_with_float32_statistics(fused):
    cfg = MopoeConfig(**KW, compute_dtype="bfloat16", bn_compute_dtype="compute",
                      fused_pointwise=fused)
    state = create_train_state(cfg, device="cpu", seed=2)
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, (inputs[0].dtype, output.dtype))
        return hook

    hooks = [m.register_forward_hook(record(name)) for name, m in state.model.named_modules()
             if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    make_train_step(cfg)(state, port_batch(numpy_batch(seed=2)))
    for h in hooks:
        h.remove()
    # every BN run as a module takes and gives bfloat16 (under fused_pointwise
    # the blocks' bn1 go through the fused op instead)
    assert seen and all(d == (torch.bfloat16, torch.bfloat16) for d in seen.values()), seen
    assert fused == (not any(name.endswith("bn1") for name in seen))
    for m in _bn_modules(state.model):
        assert m.running_mean.dtype == m.running_var.dtype == torch.float32
        assert m.weight.dtype == m.weight.grad.dtype == torch.float32
        assert torch.isfinite(m.weight.grad).all() and not torch.equal(
            m.running_var, torch.ones_like(m.running_var))


# ---------------------------------------------------------------------------
# against the JAX package, bfloat16
# ---------------------------------------------------------------------------

def _img(seed):
    return np.random.default_rng(seed).random((4, 64, 64, 1)).astype(np.float32)


def _ids(seed):
    ids = np.random.default_rng(seed).integers(0, 30, (4, 128))
    ids[:, :5] = 0
    return ids


ENCODERS = {
    "image": lambda: (JI.EncoderImg(dim=4, class_dim=6, img_size=64, dtype=jnp.bfloat16,
                                    bn_dtype=jnp.bfloat16),
                      TI.EncoderImg(4, 6, 64, bn_dtype=torch.bfloat16), jnp.asarray(_img(3)),
                      torch.from_numpy(_img(3).transpose(0, 3, 1, 2).copy()), "encoder_PA",
                      "encoder_pa."),
    "word": lambda: (JT.EncoderText(dim=4, class_dim=6, text_encoding="word", vocab_size=30,
                                    len_sequence=128, dtype=jnp.bfloat16,
                                    bn_dtype=jnp.bfloat16),
                     TT.EncoderText(4, 6, 30, 128, bn_dtype=torch.bfloat16),
                     jnp.asarray(_ids(4), jnp.int32), torch.from_numpy(_ids(4)), "encoder_text",
                     "encoder_text."),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_train_mode_matches_jax_in_bfloat16(name, monkeypatch):
    monkeypatch.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
    monkeypatch.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
    j_mod, t_mod, x_jax, x_port, top, strip = ENCODERS[name]()
    rng = np.random.default_rng(5)
    variables = jax.jit(lambda k, x: j_mod.init(k, x, train=False))(jax.random.PRNGKey(5), x_jax)
    variables = {c: noisy(jax.device_get(v), rng) for c, v in variables.items()}
    t_mod.load_state_dict(port_weights(top, None, variables, strip))
    ref, _ = jax.jit(lambda v, x: j_mod.apply(v, x, train=True, mutable=["batch_stats"],
                                              rngs={"dropout": jax.random.PRNGKey(0)}))(
        variables, x_jax)
    t_mod.train()
    no_dropout(t_mod)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16, cache_enabled=False):
        got = t_mod(x_port)
    for g, r in zip(got, ref):
        g, r = g.float().numpy(), np.asarray(r, np.float32)
        assert np.isfinite(r).all() and g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0, atol=3e-2 * float(np.abs(r).max()))


BF16_CASES = {
    "compute": dict(bn_compute_dtype="compute"),
    "bfloat16": dict(bn_compute_dtype="bfloat16"),
    "compute_fused_pointwise": dict(bn_compute_dtype="compute", fused_pointwise=True),
}


def _jax_steps(case, sd, batch):
    jcfg = JaxConfig(**KW, compute_dtype="bfloat16", **BF16_CASES[case])
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

        (total, (new_bs, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, new_opt, total

    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(JR, "fused_bn_relu_pointwise", two_pass_fused_bn_relu_pointwise)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)
        for _ in range(STEPS):
            params, bstats, opt_state, total = step(params, bstats, opt_state)
            losses.append(float(total))
    return losses


@pytest.fixture(scope="module")
def bf16_runs():
    """case → (JAX losses, port losses, the port's state after the steps).
    Under bfloat16 compute the JAX package builds the same model for
    ``"compute"`` and ``"bfloat16"`` (both resolve to bfloat16,
    mmvae.py:60), so its ``"compute"`` run is the reference of both."""
    out, jax_losses = {}, {}
    batch = numpy_batch(seed=6)
    sd = create_train_state(MopoeConfig(**KW, compute_dtype="bfloat16"), device="cpu",
                            seed=6).model.state_dict()
    for case, knobs in BF16_CASES.items():
        cfg = MopoeConfig(**KW, compute_dtype="bfloat16", **knobs)
        state = create_train_state(cfg, device="cpu", state_dict=sd)
        no_dropout(state.model)
        step = make_train_step(cfg, eps=0.0)
        losses = [float(step(state, port_batch(batch))["total_loss"]) for _ in range(STEPS)]
        jax_case = "compute" if case == "bfloat16" else case
        if jax_case not in jax_losses:
            jax_losses[jax_case] = _jax_steps(jax_case, sd, batch)
        out[case] = (jax_losses[jax_case], losses, state)
    return out


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_train_steps_match_jax(bf16_runs, case):
    ref, got, _ = bf16_runs[case]
    assert len(ref) == len(got) == STEPS
    for i, (g, r) in enumerate(zip(got, ref)):
        assert np.isfinite(r) and abs(g - r) <= 2e-2 * abs(r), (i, g, r)


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_gradients_finite_and_statistics_float32(bf16_runs, case):
    _, _, state = bf16_runs[case]
    for name, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    for m in _bn_modules(state.model):
        assert m.running_mean.dtype == m.running_var.dtype == torch.float32
        assert torch.isfinite(m.running_var).all()


def test_channels_last_model_takes_jax_weights_and_checkpoints_as_nchw(tmp_path):
    """The channels-last model (bf16 BatchNorms, ``MMVae``'s rule) and the
    NCHW one (float32 BatchNorms) hold the same keys and values: from the
    JAX package's variables through ``jax_import``, and after a
    checkpoint's round trip (a train step's payload written by the NCHW
    state, loaded into the channels-last one), with Adam's states in the
    loading parameters' layout (the fused Adam reads both as flat arrays)."""
    from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
    from mopoe_mimic_tpu_torch.utils.checkpoints import load_state_payload, state_payload

    kw = dict(KW, compute_dtype="bfloat16")
    cfgs = {"cl": MopoeConfig(**kw, bn_compute_dtype="compute"), "nchw": MopoeConfig(**kw)}
    sd = create_train_state(cfgs["nchw"], device="cpu", seed=7).model.state_dict()
    variables = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, JaxConfig(**kw))
    from_jax = state_dict_from_jax(variables, cfgs["cl"])
    states = {k: create_train_state(cfg, device="cpu", state_dict=from_jax)
              for k, cfg in cfgs.items()}
    for state in states.values():
        got = state.model.state_dict()
        assert got.keys() == sd.keys() and all(torch.equal(got[k], v) for k, v in sd.items())
    convs = {k: [p for p in s.model.parameters() if p.dim() == 4] for k, s in states.items()}
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in convs["cl"])
    assert any(not p.is_contiguous() for p in convs["cl"])
    assert all(p.is_contiguous() for p in convs["nchw"])

    make_train_step(cfgs["nchw"])(states["nchw"], port_batch(numpy_batch(seed=3)))
    torch.save(state_payload(states["nchw"]), tmp_path / "state.pt")
    load_state_payload(states["cl"], torch.load(tmp_path / "state.pt", weights_only=False))
    want = states["nchw"].model.state_dict()
    got = states["cl"].model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], v) for k, v in want.items())
    assert all(p.is_contiguous(memory_format=torch.channels_last) for p in convs["cl"])
    opt_cl, opt_nchw = states["cl"].optimizer, states["nchw"].optimizer
    for p_cl, p_nchw in zip(states["cl"].model.parameters(), states["nchw"].model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            a, b = opt_cl.state[p_cl][key], opt_nchw.state[p_nchw][key]
            assert torch.equal(a, b) and a.stride() == p_cl.stride(), key
