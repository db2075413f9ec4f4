"""The serving slice of the port (mopoe_mimic_tpu_torch.serve) against the
JAX package's InferenceSession, on the same weights, float32, CPU.

The JAX session is built as tests/test_serve.py builds it; its variables
get seeded noise and reach the port through ``state_dict_from_jax``.
Tolerance as in test_torch_port_modules.py: rtol 1e-4 and atol
1e-5·max(1, max|ref|). Random streams differ between the frameworks, so
generation is compared through an injected eps (z = mu) only.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.data.loader import BatchLoader
from mopoe_mimic_tpu.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.serve import InferenceSession as JaxSession
from mopoe_mimic_tpu.train.state import create_train_state
from mopoe_mimic_tpu_torch import serve as port_serve
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.serve import InferenceSession
from test_torch_port_modules import assert_close, noisy

KW = dict(dataset="testing", batch_size=6, class_dim=4, DIM_img=4, DIM_text=4,
          img_size=64, text_encoding="word", vocab_size=30, compute_dtype="float32")
SUBSETS = {"PA", "Lateral", "text", "Lateral_PA", "PA_text", "Lateral_text", "Lateral_PA_text"}


@pytest.fixture(scope="module")
def pairs():
    """method → (JAX session, port session, numpy batch, variables)."""
    out = {}
    for i, method in enumerate(("joint_elbo", "poe")):
        jcfg = JaxConfig(method=method, **KW)
        batch, _ = next(iter(BatchLoader(SyntheticMimic(jcfg, seed=0), jcfg.batch_size,
                                         shuffle=False)))
        batch = {k: np.asarray(v) for k, v in batch.items()}
        state = create_train_state(jcfg, jax.random.PRNGKey(0), batch)
        rng = np.random.default_rng(i)
        variables = {"params": noisy(jax.device_get(state.params), rng),
                     "batch_stats": noisy(jax.device_get(state.batch_stats), rng)}
        state = state.replace(**variables)
        jsess = JaxSession(cfg=jcfg, state=state, buckets=(2, 4))
        pcfg = MopoeConfig(method=method, **KW)
        psess = InferenceSession(pcfg, state_dict=state_dict_from_jax(variables, pcfg),
                                 device="cpu", buckets=(2, 4))
        out[method] = (jsess, psess, batch, variables)
    return out


@pytest.mark.parametrize("n", [3, 6])  # 3 pads to bucket 4; 6 chunks as 4 + 2
@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
def test_encode_matches_jax(pairs, method, n):
    jsess, psess, batch, _ = pairs[method]
    rows = {k: v[:n] for k, v in batch.items()}
    ref, got = jsess.encode(rows), psess.encode(rows)
    assert set(got["subsets"]) == set(ref["subsets"]) == SUBSETS
    for key in SUBSETS:
        for g, r in zip(got["subsets"][key], ref["subsets"][key]):
            assert g.shape == (n, KW["class_dim"])
            assert_close(g, r)
    for g, r in zip(got["joint"], ref["joint"]):
        assert_close(g, r)


def test_cond_generation_means_match_jax(pairs):
    """eps = 0 decodes each subset's posterior mean: the port's
    cond_generation against JAX generate_from_latents(mu_S). Text is
    compared as probabilities with the tolerance its log-probabilities
    get: |Δp| <= |Δlog p| for p <= 1."""
    jsess, psess, batch, _ = pairs["joint_elbo"]
    lat = jsess.encode({k: v[:3] for k, v in batch.items()})["subsets"]
    keys = list(lat)
    z_all = np.concatenate([lat[k][0] for k in keys])
    ref, ref_logp = jax.device_get(jsess.model.apply(
        {"params": jsess.params, "batch_stats": jsess.batch_stats}, z_all,
        method=lambda m, z: (m.generate_from_latents(z, train=False),
                             m.decoders["text"](z, train=False))))
    with torch.inference_mode():
        got = psess.model.cond_generation(
            {k: (torch.tensor(mu), torch.tensor(lv)) for k, (mu, lv) in lat.items()}, eps=0.0)
    assert np.isfinite(ref_logp).all()
    text_atol = 1e-5 * max(1.0, float(np.abs(ref_logp).max()))
    for i, key in enumerate(keys):
        rows = slice(3 * i, 3 * (i + 1))
        for m in ("PA", "Lateral"):
            assert_close(got[key][m].numpy().transpose(0, 2, 3, 1), ref[m][rows])
        np.testing.assert_allclose(got[key]["text"].numpy(), ref["text"][rows],
                                   rtol=1e-4, atol=text_atol)


def test_generate_shapes_determinism_and_compact(pairs):
    _, psess, _, _ = pairs["joint_elbo"]
    out = psess.generate(5, seed=1)  # chunks 4 + 1 → buckets 4, 2
    assert out["PA"].shape == out["Lateral"].shape == (5, 64, 64, 1)
    assert out["text"].shape == (5, 128, 30)
    assert all(np.isfinite(v).all() for v in out.values())
    np.testing.assert_allclose(out["text"].sum(-1), 1.0, atol=1e-5)
    again = psess.generate(5, seed=1)
    for m in out:
        np.testing.assert_array_equal(out[m], again[m])
    assert np.abs(psess.generate(5, seed=2)["PA"] - out["PA"]).max() > 0
    compact = psess.generate(5, seed=1, compact=True)
    assert compact["text"].dtype == np.int32
    np.testing.assert_array_equal(compact["text"], np.argmax(out["text"], axis=-1))
    for m in ("PA", "Lateral"):
        assert compact[m].dtype == np.uint8
        np.testing.assert_array_equal(
            compact[m], np.clip(out[m] * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_cond_generate_all_subsets(pairs):
    _, psess, batch, _ = pairs["joint_elbo"]
    rows = {k: v[:3] for k, v in batch.items()}
    full = psess.cond_generate(rows, seed=4)
    compact = psess.cond_generate(rows, seed=4, compact=True)
    assert set(full) == set(compact) == SUBSETS
    for key in SUBSETS:
        assert full[key]["PA"].shape == (3, 64, 64, 1)
        assert compact[key]["text"].dtype == np.int32 and compact[key]["text"].shape == (3, 128)
        assert compact[key]["Lateral"].dtype == np.uint8
        np.testing.assert_array_equal(compact[key]["text"], np.argmax(full[key]["text"], -1))


@pytest.mark.parametrize("method", ["joint_elbo", "poe"])
def test_state_dict_round_trip_is_exact(pairs, method):
    """convert_mopoe_state_dict(state_dict_from_jax(v)) == v, leaf for leaf."""
    *_, variables = pairs[method]
    back = convert_mopoe_state_dict(state_dict_from_jax(variables, MopoeConfig(**KW)),
                                    JaxConfig(**KW))
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[col])
        got = jax.tree_util.tree_leaves_with_path(back[col])
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, w), (_, g) in zip(want, got):
            assert w.dtype == g.dtype and w.shape == g.shape, path
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_port_state_dict_names_the_jax_tree(pairs):
    """The port's own state_dict converts to exactly the JAX MMVae tree."""
    *_, variables = pairs["joint_elbo"]
    port_sd = MMVae(MopoeConfig(**KW)).state_dict()
    assert set(port_sd) == set(state_dict_from_jax(variables, MopoeConfig(**KW)))
    conv = convert_mopoe_state_dict(port_sd, JaxConfig(**KW))
    for col in ("params", "batch_stats"):
        assert (jax.tree_util.tree_structure(conv[col])
                == jax.tree_util.tree_structure(variables[col]))
        for a, b in zip(jax.tree_util.tree_leaves(conv[col]),
                        jax.tree_util.tree_leaves(variables[col])):
            assert np.shape(a) == np.shape(b)


def test_serve_cli_writes_samples(pairs, tmp_path):
    *_, variables = pairs["joint_elbo"]
    cfg_path, weights = tmp_path / "config.json", tmp_path / "w.pt"
    cfg_path.write_text(json.dumps(dict(method="joint_elbo", **KW)))
    torch.save(state_dict_from_jax(variables, MopoeConfig(**KW)), weights)
    out = tmp_path / "samples"
    port_serve.main(["--config", str(cfg_path), "--weights", str(weights), "--mode", "generate",
                     "--num_samples", "3", "--device", "cpu", "--compact", "--out", str(out)])
    ids = np.load(out / "text_ids.npy")
    assert ids.dtype == np.int32 and ids.shape == (3, 128)
    # images as PNG grids (uint8 samples, 3 in a row of 64 px squares)
    from PIL import Image

    with Image.open(out / "PA.png") as png:
        assert png.mode == "L" and png.size == (3 * 64, 64)


def test_chip_smoke_slice_phase_rehearses_on_cpu(pairs):
    """chip_smoke.py's slice phase (drive and checks), at this file's small
    width on the CPU: the card run differs only in width and device."""
    import chip_smoke

    *_, variables = pairs["joint_elbo"]
    cfg = MopoeConfig(method="joint_elbo", **KW)
    sess = InferenceSession(cfg, state_dict=state_dict_from_jax(variables, cfg), device="cpu",
                            buckets=(1, 8, 32))
    outs = chip_smoke.drive_slice(sess, n_encode=40, n_generate=16, n_cond=8)
    chip_smoke.check_slice(cfg, outs, n_encode=40, n_generate=16, n_cond=8)
    sd = chip_smoke.random_state_dict(cfg)
    assert set(sd) == set(sess.model.state_dict())
    sess = InferenceSession(cfg, state_dict=sd, device="cpu")
    chip_smoke.check_slice(cfg, chip_smoke.drive_slice(sess))
