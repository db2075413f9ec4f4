"""The port's entry points run on the card unless the caller asks for the
CPU: ``InferenceSession``, ``create_train_state`` and the serve CLI default
to ``"cuda"``, with no fallback to the CPU when there is no card. And the
model refuses the configuration knobs that the port has not ported
(``bn_compute_dtype``, ``remat``) instead of ignoring them."""

import inspect
import json

import pytest
import torch

from mopoe_mimic_tpu_torch import serve
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.train.state import create_train_state

SMALL = dict(img_size=64, DIM_img=4, DIM_text=4, class_dim=4, text_encoding="word",
             vocab_size=30, batch_size=2, compute_dtype="float32")
CLI = ["--config", "c.json", "--weights", "w.pt", "--out", "out"]


@pytest.mark.parametrize("entry", [InferenceSession, create_train_state])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_serve_cli_defaults_to_the_card():
    assert serve.build_parser().parse_args(CLI).device == "cuda"
    assert serve.build_parser().parse_args(CLI + ["--device", "cpu"]).device == "cpu"


def test_entry_points_without_a_card_fail_instead_of_falling_back(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    cfg = MopoeConfig(**SMALL)
    with pytest.raises((AssertionError, RuntimeError)):
        InferenceSession(cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        create_train_state(cfg)
    cfg_path, weights = tmp_path / "config.json", tmp_path / "w.pt"
    cfg_path.write_text(json.dumps(cfg.to_dict()))
    torch.save(InferenceSession(cfg, device="cpu").model.state_dict(), weights)
    with pytest.raises((AssertionError, RuntimeError)):
        serve.main(["--config", str(cfg_path), "--weights", str(weights),
                    "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("knob,value", [("bn_compute_dtype", "compute"),
                                        ("bn_compute_dtype", "bfloat16"),
                                        ("remat", "blocks"), ("remat", "conv")])
@pytest.mark.parametrize("entry", [MMVae, lambda cfg: create_train_state(cfg, device="cpu")],
                         ids=["MMVae", "create_train_state"])
def test_unported_knobs_raise(entry, knob, value):
    """Every BatchNorm of the port runs in float32 and nothing is
    rematerialised: a config that asks otherwise is refused, not run with
    other numerics than the JAX package's."""
    with pytest.raises(NotImplementedError, match=knob):
        entry(MopoeConfig(**SMALL, **{knob: value}))


def test_default_knobs_construct():
    cfg = MopoeConfig(**SMALL)
    assert (cfg.bn_compute_dtype, cfg.remat) == ("float32", "none")
    MMVae(cfg)
    create_train_state(cfg, device="cpu")
