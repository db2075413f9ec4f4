"""The char-1024 text path and the word path at len_sequence >= 512 of the
port (mopoe_mimic_tpu_torch/models/text_networks.py, models/mmvae.py,
models/jax_import.py) against the JAX package's, float32 on the CPU, at
small width (DIM 4, class_dim 6 or 4, batch 4, 64 px).

Weights are the JAX modules' own, with seeded noise, carried to the port
by ``state_dict_from_jax``. Networks: as tests/test_torch_port_modules.py,
in eval mode and in train mode with dropout off (rtol 1e-4, atol
1e-5·max(1, max|ref|); the running statistics too). ``MMVae`` under char:
every subset posterior and the joint. One train step per method on char:
as tests/test_torch_port_train.py (the JAX side on its two-pass BatchNorm
variance, z = mu), loss terms rtol 1e-4, gradients per leaf
1e-4·max|g_leaf| + 1e-7·g_max.

The text head's layout depends on the configuration (a ConvTranspose1d
for char and word >= 512, a plain Conv1d for word 128): the converters
round-trip exactly on char and word-1024 weights, and a converter that
skips the transposed convolutions' spatial flip gives outputs of the
right shape that the parity check refuses.
"""

import types

import jax
import numpy as np
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.models import text_networks as JT
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models import jax_import
from mopoe_mimic_tpu_torch.models import text_networks as TT
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import make_train_step
from test_torch_port_modules import (  # noqa: F401 (no_jax_dropout: a fixture)
    assert_close,
    assert_stats_close,
    no_jax_dropout,
    noisy,
    run_pair,
)
from test_torch_port_train import jax_run, loss_terms, no_dropout, port_run

DIM, CLASS_DIM, BATCH, VOCAB, LONG = 4, 6, 4, 30, 1024
ALPHABET = 71
CHAR = types.SimpleNamespace(text_encoding="char", len_sequence=LONG)
WORD_LONG = types.SimpleNamespace(text_encoding="word", len_sequence=LONG)
KW = dict(dataset="testing", batch_size=BATCH, class_dim=4, DIM_img=4, DIM_text=4,
          img_size=64, text_encoding="char", compute_dtype="float32",
          initial_learning_rate=5e-4)
METHODS = ("joint_elbo", "poe", "moe", "jsd")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's small models (as
    tests/test_torch_port_loop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _onehot(seed, n=BATCH):
    ids = np.random.default_rng(seed).integers(0, ALPHABET, (n, LONG))
    return np.eye(ALPHABET, dtype=np.float32)[ids]


def _ids(seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (BATCH, LONG))
    ids[:, :5] = 0
    return ids


def _z(seed):
    return np.random.default_rng(seed).normal(size=(BATCH, CLASS_DIM)).astype(np.float32)


NETWORKS = {
    # name: (JAX module, port module, JAX input, port input, top, key prefix,
    #        converter cfg, output → list of arrays)
    "char_encoder": lambda: (
        JT.EncoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="char", len_sequence=LONG),
        TT.EncoderText(DIM, CLASS_DIM, ALPHABET, LONG, text_encoding="char"),
        _onehot(1), torch.from_numpy(_onehot(1)), "encoder_text", "encoder_text.", CHAR,
        lambda out: [o.numpy() for o in out]),
    "char_decoder": lambda: (
        JT.DecoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="char",
                       num_features=ALPHABET, len_sequence=LONG),
        TT.DecoderText(DIM, CLASS_DIM, ALPHABET, LONG, text_encoding="char"),
        _z(2), torch.from_numpy(_z(2)), "decoder_text", "decoder_text.", CHAR,
        lambda out: [out.numpy()]),
    "word1024_encoder": lambda: (
        JT.EncoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word", vocab_size=VOCAB,
                       len_sequence=LONG),
        TT.EncoderText(DIM, CLASS_DIM, VOCAB, LONG),
        _ids(3).astype(np.int32), torch.from_numpy(_ids(3)), "encoder_text", "encoder_text.",
        WORD_LONG, lambda out: [o.numpy() for o in out]),
    "word1024_decoder": lambda: (
        JT.DecoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word", num_features=VOCAB,
                       len_sequence=LONG, last_layer="softmax"),
        TT.DecoderText(DIM, CLASS_DIM, VOCAB, LONG),
        _z(4), torch.from_numpy(_z(4)), "decoder_text", "decoder_text.", WORD_LONG,
        lambda out: [out.numpy()]),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_network_matches_jax(name, train, no_jax_dropout):
    j_mod, t_mod, x_jax, x_port, top, strip, cfg, outputs = NETWORKS[name]()
    out = run_pair(j_mod, t_mod, jax.numpy.asarray(x_jax), x_port, top, None, strip, seed=5,
                   train=train, cfg=cfg)
    got, ref = outputs(out[0]), out[1]
    for g, r in zip(got, ref if isinstance(ref, tuple) else [ref]):
        assert_close(g, r)
    if name.endswith("decoder"):
        assert got[0].shape == (BATCH, LONG, ALPHABET if "char" in name else VOCAB)
    if train:
        assert_stats_close(out[2], out[3])


def test_text_lengths_other_than_the_jax_package_s_raise():
    with pytest.raises(NotImplementedError, match="len_sequence 256"):
        TT.EncoderText(DIM, CLASS_DIM, VOCAB, 256)
    with pytest.raises(NotImplementedError, match="len_sequence 128"):
        TT.DecoderText(DIM, CLASS_DIM, ALPHABET, 128, text_encoding="char")
    with pytest.raises(NotImplementedError, match="prehead"):
        TT.DecoderText(DIM, CLASS_DIM, ALPHABET, LONG, text_encoding="char")(
            torch.zeros(2, CLASS_DIM), prehead=True)
    assert TT.EncoderText(DIM, CLASS_DIM, VOCAB, 512).feature_extractor.n_blocks == 8


def test_a_transpose_conv_without_its_flip_fails_the_parity_check():
    """The char head ``conv2`` (and every transposed conv) converted without
    the spatial flip: the port still loads it and gives outputs of the right
    shape, and only the parity check tells."""
    j_mod, t_mod, x_jax, x_port, top, strip, cfg, outputs = NETWORKS["char_decoder"]()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_import, "_convT_w", lambda k: np.transpose(k, (1, 2, 0)))
        got, ref = run_pair(j_mod, t_mod, jax.numpy.asarray(x_jax), x_port, top, None, strip,
                            seed=5, cfg=cfg)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    with pytest.raises(AssertionError):
        assert_close(got, ref)


def _word_long(cfg):
    """``cfg`` at word len_sequence 1024, which the configuration forces
    to 128 (the networks and converters take it; flags.py:157)."""
    object.__setattr__(cfg, "len_sequence", LONG)
    return cfg


@pytest.mark.parametrize("text", ["char", "word1024"])
def test_converters_round_trip_exactly(text):
    """state_dict_from_jax ∘ convert_mopoe_state_dict is the identity on
    the port's MMVae weights (seeded noise on every tensor)."""
    cfg = MopoeConfig(**dict(KW, text_encoding="char" if text == "char" else "word",
                             vocab_size=VOCAB))
    if text == "word1024":
        cfg = _word_long(cfg)
    torch.manual_seed(1)
    sd = {k: v + torch.randn_like(v.float()).to(v.dtype) if v.is_floating_point() else v
          for k, v in MMVae(cfg).state_dict().items()}
    back = state_dict_from_jax(convert_mopoe_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg), cfg)
    assert set(back) == set(sd)
    head = ("decoder_text.text_generator.conv2.weight" if text == "char" else
            "decoder_text.text_generator.generator.8.weight")
    assert sd[head].shape == (4, cfg.num_features, 4)  # ConvTranspose1d (I, O, k)
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# MMVae and the train step under char
# ---------------------------------------------------------------------------

def _jax_variables(method, seed):
    """Noisy variables of the JAX MMVae under char at KW's width."""
    jcfg = JaxConfig(method=method, **KW)
    batch = {k: jax.numpy.asarray(v) for k, v in char_batch(seed).items()}
    variables = jax_mmvae.MMVae(jcfg).init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(1),
         "reparam": jax.random.PRNGKey(2)}, batch, train=False)
    rng = np.random.default_rng(seed)
    return {c: noisy(jax.device_get(v), rng) for c, v in variables.items()}


def char_batch(seed, n=BATCH):
    """The JAX layout: NHWC images, a one-hot [B, 1024, 71]."""
    rng = np.random.default_rng(seed)
    return {"PA": rng.random((n, 64, 64, 1), dtype=np.float32),
            "Lateral": rng.random((n, 64, 64, 1), dtype=np.float32),
            "text": _onehot(seed + 100, n)}


def _port_batch(batch):
    return {k: torch.from_numpy(v.transpose(0, 3, 1, 2).copy() if v.ndim == 4 else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("method", ["joint_elbo", "moe"])
def test_char_inference_matches_jax(method):
    """Every subset posterior and the joint, eval mode."""
    variables = _jax_variables(method, seed=7)
    jcfg, cfg = JaxConfig(method=method, **KW), MopoeConfig(method=method, **KW)
    model = MMVae(cfg).eval()
    model.load_state_dict(state_dict_from_jax(variables, cfg))
    batch = char_batch(8)
    ref = jax_mmvae.MMVae(jcfg).apply(variables, {k: jax.numpy.asarray(v)
                                                  for k, v in batch.items()},
                                      train=False, method=jax_mmvae.MMVae.inference)
    with torch.no_grad():
        got = model.inference(_port_batch(batch))
    assert list(got["subsets"]) == list(ref["subsets"]) and len(got["subsets"]) == 7
    for key, pair in ref["subsets"].items():
        for g, r in zip(got["subsets"][key], pair):
            assert_close(g.numpy(), np.asarray(r))
    for g, r in zip(got["joint"], ref["joint"]):
        assert_close(g.numpy(), np.asarray(r))


@pytest.fixture(scope="module")
def char_steps():
    """method → (JAX run, port run, the port's float64 gradients): one Adam
    step on char from the same weights (the JAX init's, through
    state_dict_from_jax) and batch."""
    out = {}
    for i, method in enumerate(METHODS):
        config = dict(KW, method=method)
        sd = state_dict_from_jax(_jax_variables(method, seed=20 + i), MopoeConfig(**config))
        batch = char_batch(30 + i)
        oracle = port_run(method, {k: v.double() if v.is_floating_point() else v
                                   for k, v in sd.items()},
                          {k: v.astype(np.float64) for k, v in batch.items()}, 1,
                          config=dict(config, compute_dtype="float64", param_dtype="float64"))
        out[method] = (jax_run(method, sd, batch, 1, config=config),
                       port_run(method, sd, batch, 1, config=config), oracle[1][0])
    return out


@pytest.mark.parametrize("method", METHODS)
def test_char_train_step_matches_jax(char_steps, method):
    """Loss terms rtol 1e-4; gradients per leaf as
    tests/test_torch_port_train.py::test_gradients_match_jax (leaves whose
    gradient is zero in exact arithmetic held to 1e-5·g_max); the BN
    running statistics after the step.

    A leaf where either float32 gradient misses the float64 oracle (the
    port's step in float64) by more than that tolerance is one that float32
    does not resolve to it: a sum that nearly cancels, as the char stem's
    bias, whose gradient is a sum over the batch's 4 × 512 positions that
    CPU float32 takes in one order and XLA in another (a relative 2.6e-4 off
    the oracle for the port, 1.6e-4 for JAX, in the moe and jsd cases).
    Such leaves, at most two, hold both float32 gradients to the oracle at
    1e-3·max|g_leaf|, the float32 floor of chip_smoke.py's
    gpu_step_against_cpu; the oracle is the port's own arithmetic, so JAX's
    float32 gradient against it still checks the port's logic there."""
    (j_terms, (j_grads, j_stats)), (p_terms, (p_grads, p_stats, m), _), g64 = char_steps[method]
    assert j_terms[0].keys() == p_terms[0].keys()
    for k, ref in j_terms[0].items():
        assert np.isfinite(ref), k
        np.testing.assert_allclose(p_terms[0][k], ref, rtol=1e-4, err_msg=k)
    assert j_grads.keys() == p_grads.keys() == g64.keys()
    g_max = max(float(g.abs().max()) for g in j_grads.values())
    tiny, unresolved = 0, []
    for k, ref in j_grads.items():
        ref, got, exact = ref.numpy(), p_grads[k].numpy(), g64[k].numpy()
        if max(np.abs(ref).max(), np.abs(got).max()) <= 1e-5 * g_max:
            tiny += 1
            continue
        atol = 1e-4 * float(np.abs(ref).max()) + 1e-7 * g_max
        if max(np.abs(ref - exact).max(), np.abs(got - exact).max()) > atol:
            unresolved.append(k)
            for g in (ref, got):
                np.testing.assert_allclose(g, exact, rtol=0, err_msg=k,
                                           atol=1e-3 * float(np.abs(exact).max()))
            continue
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=k)
    assert tiny < 0.2 * len(j_grads), tiny
    assert len(unresolved) <= 2, unresolved
    assert j_stats.keys() == p_stats.keys() and j_stats
    for k in j_stats:
        assert_close(p_stats[k].numpy(), j_stats[k].numpy())


def test_char_ignores_the_fused_text_head():
    """``fused_text_head`` applies to word-128 only (step.py:45-55 of the
    JAX package): under char the step is the same with it on or off."""
    batch = _port_batch(char_batch(40))
    cfg = MopoeConfig(**KW)
    sd = MMVae(cfg).state_dict()
    terms = []
    for fused in (False, True):
        c = cfg.replace(fused_text_head=fused)
        state = create_train_state(c, device="cpu", state_dict=sd)
        no_dropout(state.model)
        terms.append(loss_terms(make_train_step(c, eps=0.0)(state, batch)))
    assert terms[0] == terms[1] and np.isfinite(terms[0]["total_loss"])
