"""The port's entry points run on the card unless the caller asks for the
CPU: ``InferenceSession``, ``create_train_state``, ``Experiment``,
``run_epochs``, ``Main``, the training CLI's ``main`` and the serve CLI
default to ``"cuda"``, with no fallback to the CPU when there is no card.
And the model refuses the configuration knob that the port has not ported
(``remat``) instead of ignoring it, while it builds every BatchNorm in the
dtype ``bn_compute_dtype`` asks for."""

import inspect
import json

import pytest
import torch

from mopoe_mimic_tpu_torch import main as train_cli
from mopoe_mimic_tpu_torch import serve
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.models.resblocks import _ResidualBlock
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.train.loop import run_epochs
from mopoe_mimic_tpu_torch.train.state import create_train_state

SMALL = dict(img_size=64, DIM_img=4, DIM_text=4, class_dim=4, text_encoding="word",
             vocab_size=30, batch_size=2, compute_dtype="float32")
CLI = ["--config", "c.json", "--weights", "w.pt", "--out", "out"]


@pytest.mark.parametrize("entry", [InferenceSession, create_train_state, Experiment, run_epochs,
                                   train_cli.Main, train_cli.main])
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
    runs = tmp_path / "runs"
    train_cfg = cfg.replace(dataset="testing", dir_experiment=str(runs), eval_lr=False,
                            calc_nll=False, use_clf=False)
    with pytest.raises((AssertionError, RuntimeError)):
        Experiment(train_cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        train_cli.Main(train_cfg)
    with pytest.raises((AssertionError, RuntimeError)):
        train_cli.main(["--config_path", str(cfg_path), "--dataset", "testing",
                        "--dir_experiment", str(runs)])
    assert not runs.exists()
    with pytest.raises((AssertionError, RuntimeError)):
        run_epochs(Experiment(train_cfg, device="cpu"))


@pytest.mark.parametrize("knob,value", [("bn_compute_dtype", "compute"),
                                        ("bn_compute_dtype", "bfloat16"),
                                        ("remat", "blocks"), ("remat", "conv")])
@pytest.mark.parametrize("entry", [MMVae, lambda cfg: create_train_state(cfg, device="cpu")],
                         ids=["MMVae", "create_train_state"])
def test_unported_knobs_raise(entry, knob, value):
    """Nothing is rematerialised: a config that asks for ``remat`` is
    refused, not run with other numerics than the JAX package's.
    ``bn_compute_dtype`` is ported: the model builds, every residual block's
    BatchNorm in the dtype it resolves to (``"compute"`` the compute dtype,
    float32 here), with float32 running statistics."""
    cfg = MopoeConfig(**SMALL, **{knob: value})
    if knob == "remat":
        with pytest.raises(NotImplementedError, match=knob):
            entry(cfg)
        return
    built = entry(cfg)
    model = built if isinstance(built, MMVae) else built.model
    expected = torch.float32 if value == "compute" else getattr(torch, value)
    blocks = [m for m in model.modules() if isinstance(m, _ResidualBlock)]
    assert blocks and all(b.bn_dtype == expected for b in blocks)
    assert all(m.running_var.dtype == torch.float32 for m in model.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm))


def test_default_knobs_construct():
    cfg = MopoeConfig(**SMALL)
    assert (cfg.bn_compute_dtype, cfg.remat) == ("float32", "none")
    MMVae(cfg)
    create_train_state(cfg, device="cpu")
