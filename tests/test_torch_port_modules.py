"""The port's networks (mopoe_mimic_tpu_torch/models) against the JAX
package's, module by module, float32 on the CPU: in eval mode, and in
train mode with dropout off.

Each JAX module is initialised, its params and batch_stats get seeded
noise (so that every weight, bias and running statistic matters), the
variables go through ``state_dict_from_jax`` into the port's module, and
both run the same numpy input. In train mode BatchNorm normalises with the
batch statistics and advances its running statistics (momentum 0.1,
unbiased variance: resblocks.py:197-200, 304-310 of the JAX package); the
updated running statistics are compared too. Dropout is off on both sides:
the JAX blocks' ``_dropout`` is the identity (as
tests/test_golden_mmvae_core.py patches it), the port's dropout modules
have p = 0. Tolerance: rtol 1e-4 and atol 1e-5·max(1, max|ref|) — float32
convolutions summed in another order by another library, through up to
eight layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.models import img_networks as JI
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models import text_networks as JT
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models import img_networks as TI
from mopoe_mimic_tpu_torch.models import resblocks as TR
from mopoe_mimic_tpu_torch.models import text_networks as TT
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax

DIM, CLASS_DIM, VOCAB, BATCH, IMG, LEN = 4, 6, 30, 4, 64, 128
CFG = MopoeConfig(text_encoding="word", vocab_size=VOCAB)


def noisy(tree, rng):
    """Seeded noise on every leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = noisy(v, rng)
        elif k == "var":
            # running variances of 4-16 keep activations O(1) through the
            # a = 2 skips, as calibrated statistics would: the comparison is
            # then between finite values, not between two overflows
            out[k] = np.asarray(v) * rng.uniform(4.0, 16.0, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v) + 0.1 * rng.normal(size=np.shape(v)).astype(np.float32)
    return out


def assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    assert np.isfinite(ref).all()
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


def port_weights(top, group, module_vars, strip, cfg=CFG):
    """Place one module's JAX variables where ``state_dict_from_jax``
    expects them in an MMVae tree, convert (``cfg``: the text encoding and
    length the layouts depend on), and strip the key prefix."""
    wrap = lambda t: {top: {group: t}} if group else {top: t}  # noqa: E731
    sd = state_dict_from_jax({"params": wrap(module_vars["params"]),
                              "batch_stats": wrap(module_vars.get("batch_stats", {}))}, cfg)
    assert all(k.startswith(strip) for k in sd), sorted(sd)[:3]
    return {k[len(strip):]: v for k, v in sd.items()}


def _placed(variables, group):
    return {c: {"resblock_1": v} for c, v in variables.items()} if group is not None else variables


def run_pair(jax_module, port_module, x_jax, x_port, top, group, strip, seed, train=False,
             cfg=CFG, **call_kw):
    """Noisy JAX variables → both modules → (port output, JAX output).
    With ``group`` set, the module is a block placed as ``resblock_1``.
    With ``train``, also → (port running stats, JAX updated running stats),
    both as the port's state_dict entries. ``cfg``: as for ``port_weights``."""
    rng = np.random.default_rng(seed)
    variables = jax_module.init(jax.random.PRNGKey(seed), x_jax, train=False, **call_kw)
    variables = {c: noisy(jax.device_get(v), rng) for c, v in variables.items()}
    port_module.load_state_dict(port_weights(top, group, _placed(variables, group), strip, cfg))
    if not train:
        ref = jax_module.apply(variables, x_jax, train=False, **call_kw)
        port_module.eval()
        with torch.no_grad():
            got = port_module(x_port, **call_kw)
        return got, ref
    ref, mut = jax_module.apply(variables, x_jax, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)}, **call_kw)
    updated = dict(variables, batch_stats=jax.device_get(mut["batch_stats"]))
    ref_stats = {k: v for k, v in port_weights(top, group, _placed(updated, group), strip,
                                                cfg).items()
                 if k.endswith(("running_mean", "running_var"))}
    port_module.train()
    for mod in port_module.modules():
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
            mod.p = 0.0
    with torch.no_grad():
        got = port_module(x_port, **call_kw)
    sd = port_module.state_dict()
    return got, ref, {k: sd[k] for k in ref_stats}, ref_stats


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)


def assert_stats_close(got, ref):
    assert got.keys() == ref.keys() and got
    for k in ref:
        assert_close(got[k].numpy(), ref[k].numpy())


BLOCKS = {
    # name: (JAX class, port class, spatial, JAX kwargs, top, group, key prefix)
    "2d_conv": (JR.ResidualBlockConv, TR.ResidualBlock2dConv, 2,
                dict(use_conv_bias=False, channelwise_dropout=True),
                "encoder_PA", "feature_extractor", "encoder_pa.feature_extractor.resblock_1.0."),
    "2d_transpose": (JR.ResidualBlockTransposeConv, TR.ResidualBlock2dTransposeConv, 2,
                     dict(use_conv_bias=False, channelwise_dropout=True),
                     "decoder_PA", "img_generator", "decoder_pa.img_generator.generator.0.0."),
    "1d_conv": (JR.ResidualBlockConv, TR.ResidualBlock1dConv, 1, {},
                "encoder_text", "feature_extractor", "encoder_text.feature_extractor.resblock_1.0."),
    "1d_transpose": (JR.ResidualBlockTransposeConv, TR.ResidualBlock1dTransposeConv, 1, {},
                     "decoder_text", "text_generator", "decoder_text.text_generator.generator.0.0."),
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_residual_block_matches_jax(kind):
    j_cls, t_cls, spatial, kw, top, group, strip = BLOCKS[kind]
    cin, cout = 3, 5
    rng = np.random.default_rng(1)
    shape = (BATCH,) + (8,) * spatial + (cin,)
    x = rng.normal(size=shape).astype(np.float32)
    x_port = torch.from_numpy(np.moveaxis(x, -1, 1).copy())  # channels first
    j_mod = j_cls(features=cout, kernel_size=4, stride=2, padding=1, **kw)
    t_mod = t_cls(cin, cout, 4, 2, 1)
    got, ref = run_pair(j_mod, t_mod, jnp.asarray(x), x_port, top, group, strip, seed=2)
    assert_close(np.moveaxis(got.numpy(), 1, -1), ref)


def test_image_encoder_matches_jax():
    x = np.random.default_rng(3).random((BATCH, IMG, IMG, 1)).astype(np.float32)
    got, ref = run_pair(
        JI.EncoderImg(dim=DIM, class_dim=CLASS_DIM, img_size=IMG),
        TI.EncoderImg(DIM, CLASS_DIM, IMG),
        jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
        "encoder_PA", None, "encoder_pa.", seed=4)
    for g, r in zip(got, ref):
        assert_close(g.numpy(), r)


def test_image_decoder_matches_jax():
    z = np.random.default_rng(5).normal(size=(BATCH, CLASS_DIM)).astype(np.float32)
    got, ref = run_pair(
        JI.DecoderImg(dim=DIM, class_dim=CLASS_DIM, img_size=IMG),
        TI.DecoderImg(DIM, CLASS_DIM, IMG),
        jnp.asarray(z), torch.from_numpy(z), "decoder_PA", None, "decoder_pa.", seed=6)
    assert got.shape == (BATCH, 1, IMG, IMG)
    assert_close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_word_encoder_matches_jax():
    ids = np.random.default_rng(7).integers(0, VOCAB, (BATCH, LEN))
    ids[:, :5] = 0  # index 0 is masked to a zero embedding on both sides
    got, ref = run_pair(
        JT.EncoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word",
                       vocab_size=VOCAB, len_sequence=LEN),
        TT.EncoderText(DIM, CLASS_DIM, VOCAB, LEN),
        jnp.asarray(ids, jnp.int32), torch.from_numpy(ids), "encoder_text", None,
        "encoder_text.", seed=8)
    for g, r in zip(got, ref):
        assert_close(g.numpy(), r)


def test_word_decoder_matches_jax():
    z = np.random.default_rng(9).normal(size=(BATCH, CLASS_DIM)).astype(np.float32)
    got, ref = run_pair(
        JT.DecoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word",
                       num_features=VOCAB, len_sequence=LEN, last_layer="softmax"),
        TT.DecoderText(DIM, CLASS_DIM, VOCAB, LEN),
        jnp.asarray(z), torch.from_numpy(z), "decoder_text", None, "decoder_text.", seed=10)
    assert got.shape == (BATCH, LEN, VOCAB)
    assert_close(got.numpy(), ref)


# ---------------------------------------------------------------------------
# train mode: batch statistics and the running-statistics update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_residual_block_train_mode_matches_jax(kind, no_jax_dropout):
    j_cls, t_cls, spatial, kw, top, group, strip = BLOCKS[kind]
    cin, cout = 3, 5
    x = np.random.default_rng(11).normal(size=(BATCH,) + (8,) * spatial + (cin,)).astype(np.float32)
    got, ref, stats, ref_stats = run_pair(
        j_cls(features=cout, kernel_size=4, stride=2, padding=1, **kw), t_cls(cin, cout, 4, 2, 1),
        jnp.asarray(x), torch.from_numpy(np.moveaxis(x, -1, 1).copy()), top, group, strip,
        seed=12, train=True)
    assert_close(np.moveaxis(got.numpy(), 1, -1), ref)
    assert_stats_close(stats, ref_stats)


def _img(seed):
    return np.random.default_rng(seed).random((BATCH, IMG, IMG, 1)).astype(np.float32)


def _z(seed):
    return np.random.default_rng(seed).normal(size=(BATCH, CLASS_DIM)).astype(np.float32)


def _ids(seed):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (BATCH, LEN))
    ids[:, :5] = 0
    return ids


TRAIN_MODULES = {
    # name: (JAX module, port module, JAX input, port input, top, key prefix,
    #        JAX call kwargs, port output → JAX layout)
    "image_encoder": lambda: (
        JI.EncoderImg(dim=DIM, class_dim=CLASS_DIM, img_size=IMG), TI.EncoderImg(DIM, CLASS_DIM, IMG),
        jnp.asarray(_img(13)), torch.from_numpy(_img(13).transpose(0, 3, 1, 2).copy()),
        "encoder_PA", "encoder_pa.", {}, lambda out: [o.numpy() for o in out]),
    "image_decoder": lambda: (
        JI.DecoderImg(dim=DIM, class_dim=CLASS_DIM, img_size=IMG), TI.DecoderImg(DIM, CLASS_DIM, IMG),
        jnp.asarray(_z(14)), torch.from_numpy(_z(14)), "decoder_PA", "decoder_pa.", {},
        lambda out: out.numpy().transpose(0, 2, 3, 1)),
    "word_encoder": lambda: (
        JT.EncoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word", vocab_size=VOCAB,
                       len_sequence=LEN),
        TT.EncoderText(DIM, CLASS_DIM, VOCAB, LEN), jnp.asarray(_ids(15), jnp.int32),
        torch.from_numpy(_ids(15)), "encoder_text", "encoder_text.", {},
        lambda out: [o.numpy() for o in out]),
    "word_decoder": lambda: (
        JT.DecoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word", num_features=VOCAB,
                       len_sequence=LEN, last_layer="softmax"),
        TT.DecoderText(DIM, CLASS_DIM, VOCAB, LEN), jnp.asarray(_z(16)), torch.from_numpy(_z(16)),
        "decoder_text", "decoder_text.", {}, lambda out: out.numpy()),
    "word_decoder_prehead": lambda: (
        JT.DecoderText(dim=DIM, class_dim=CLASS_DIM, text_encoding="word", num_features=VOCAB,
                       len_sequence=LEN, last_layer="softmax"),
        TT.DecoderText(DIM, CLASS_DIM, VOCAB, LEN), jnp.asarray(_z(17)), torch.from_numpy(_z(17)),
        "decoder_text", "decoder_text.", {"prehead": True}, lambda out: out.numpy()),
}


@pytest.mark.parametrize("name", sorted(TRAIN_MODULES))
def test_network_train_mode_matches_jax(name, no_jax_dropout):
    j_mod, t_mod, x_jax, x_port, top, strip, call_kw, to_jax = TRAIN_MODULES[name]()
    got, ref, stats, ref_stats = run_pair(j_mod, t_mod, x_jax, x_port, top, None, strip,
                                          seed=18, train=True, **call_kw)
    got = to_jax(got)
    for g, r in zip(got, ref) if isinstance(got, list) else [(got, ref)]:
        assert_close(g, r)
    assert_stats_close(stats, ref_stats)


def test_word_decoder_prehead_shape_and_head():
    """prehead returns [B, L, DIM] features; the vocab head on them gives
    the decoder's own output; the parameter set is unchanged."""
    dec = TT.DecoderText(DIM, CLASS_DIM, VOCAB, LEN).eval()
    z = torch.from_numpy(_z(19))
    with torch.no_grad():
        feats = dec(z, prehead=True)
        full = dec(z)
        head = dec.text_generator.generator[-1]
        logits = feats @ head.weight[:, :, 0].t() + head.bias
    assert feats.shape == (BATCH, LEN, DIM)
    torch.testing.assert_close(torch.log_softmax(logits, -1), full, rtol=1e-5, atol=1e-5)
