"""The port's ``MopoeConfig`` (its own copy, mopoe_mimic_tpu_torch/config.py)
against the JAX package's: the same fields in the same order with the same
types and defaults, the same derived properties, the same reading of every
``configs/*.json``, and a ``to_dict`` → JSON file → ``from_json`` round trip
that both packages read alike."""

import dataclasses
import enum
import json
from pathlib import Path

import pytest

from mopoe_mimic_tpu.config import Method as JaxMethod
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu_torch import config as port_config
from mopoe_mimic_tpu_torch.config import Method, MopoeConfig

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.json"))
DERIVED = ("len_sequence", "method_enum", "effective_eval_batch_size", "text_encoding_enum",
           "alpha_modalities", "num_features", "modality_names", "style_dims", "rec_weights",
           "style_weights", "likelihoods")


def _plain(value):
    """Enums by value, so the two packages' enum classes compare."""
    return value.value if isinstance(value, enum.Enum) else value


def _json(cfg) -> dict:
    return json.loads(json.dumps(cfg.to_dict()))


def test_fields_types_and_defaults_match_jax():
    def spec(cls):
        return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert spec(MopoeConfig) == spec(JaxConfig)
    assert dataclasses.asdict(MopoeConfig()) == dataclasses.asdict(JaxConfig())
    assert MopoeConfig.__dataclass_params__.frozen


def test_method_enum_matches_jax():
    assert [m.value for m in Method] == [m.value for m in JaxMethod]
    for m in Method:
        j = JaxMethod(m.value)
        assert (m.uses_poe_fusion, m.uses_dynamic_prior) == (j.uses_poe_fusion, j.uses_dynamic_prior)


@pytest.mark.parametrize("text_encoding", ["word", "char"])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_configs_read_the_same(path, text_encoding):
    port = MopoeConfig.from_json(str(path), text_encoding=text_encoding, only_text_modality=True)
    jax_cfg = JaxConfig.from_json(str(path), text_encoding=text_encoding, only_text_modality=True)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    for name in DERIVED:
        assert _plain(getattr(port, name)) == _plain(getattr(jax_cfg, name)), name
    full_port, full_jax = MopoeConfig.from_json(str(path)), JaxConfig.from_json(str(path))
    assert full_port.modality_names == full_jax.modality_names


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_to_dict_json_round_trip(path, tmp_path):
    cfg = MopoeConfig.from_json(str(path), fused_pointwise=True, fused_text_head=True,
                                mesh_shape=(1, 2))
    out = tmp_path / "config.json"
    out.write_text(json.dumps(cfg.to_dict()))
    assert _json(MopoeConfig.from_json(str(out))) == _json(cfg)
    # what the port writes, the JAX package reads the same way, and back
    assert _json(JaxConfig.from_json(str(out))) == _json(cfg)
    assert MopoeConfig.from_json(str(out)).replace(mesh_shape=(1, 2)) == cfg


def test_replace_matches_jax():
    kw = dict(fused_pointwise=True, batch_size=8, mesh_shape=(2, 1), bn_eps=1e-3, method="poe")
    port, jax_cfg = MopoeConfig().replace(**kw), JaxConfig().replace(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    for name in DERIVED:
        assert _plain(getattr(port, name)) == _plain(getattr(jax_cfg, name)), name
    assert port.replace(class_dim=7).class_dim == 7 and isinstance(port.replace(), MopoeConfig)


def test_port_config_loads_nothing_of_the_jax_package():
    source = Path(port_config.__file__).read_text()
    assert "importlib" not in source and "spec_from_file_location" not in source
    assert not any(line.startswith(("import mopoe_mimic_tpu", "from mopoe_mimic_tpu"))
                   and "mopoe_mimic_tpu_torch" not in line for line in source.splitlines())
    assert MopoeConfig.__module__ == "mopoe_mimic_tpu_torch.config"
