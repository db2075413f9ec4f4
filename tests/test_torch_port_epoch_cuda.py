"""The graphed epoch (mopoe_mimic_tpu_torch/train/scan.py on the card)
against the eager per-step path, at a small width on an NVIDIA GPU.

Needs the card: marked ``cuda`` and skipped where CUDA is unavailable.
Imports neither jax nor the JAX package; where they are absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_epoch_cuda.py

Float32, TF32 off, cuDNN deterministic, dropout and the reparameterisation
noise on: each replay must draw what the eager step draws. Loss terms rtol
1e-5 a step, the parameters after within 1e-5 relative L2, the
generators' states equal.
"""

import numpy as np
import pytest
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.ops import cuda_fusion, cuda_texthead
from mopoe_mimic_tpu_torch.train import losses
from mopoe_mimic_tpu_torch.train.scan import (
    epoch_index_matrix,
    make_eval_epoch,
    make_train_epoch,
)
from mopoe_mimic_tpu_torch.train.state import create_train_state, set_learning_rate
from mopoe_mimic_tpu_torch.train.step import loss_terms, make_eval_step, make_train_step

pytestmark = pytest.mark.cuda

KW = dict(dataset="testing", batch_size=4, class_dim=4, DIM_img=4, DIM_text=4, img_size=64,
          text_encoding="word", vocab_size=30, compute_dtype="float32",
          initial_learning_rate=5e-4, fused_text_head=True, lr_warmup_steps=3,
          grad_clip_norm=1000.0)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return torch.device("cuda")


def store_of(cfg, device, rows=32):
    return DeviceStore(SyntheticMimic(cfg, seed=0, length=rows), cfg, device=device)


def assert_terms_close(got, ref):
    got = {k: float(v) for k, v in loss_terms(got).items()}
    ref = {k: float(v) for k, v in loss_terms(ref).items()}
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-5, err_msg=k)


def assert_params_close(a, b):
    names = [k for k, _ in a.model.named_parameters()]
    sa, sb = a.model.state_dict(), b.model.state_dict()
    flat = lambda sd: torch.cat([sd[k].double().flatten() for k in names])  # noqa: E731
    assert float((flat(sa) - flat(sb)).norm() / flat(sb).norm()) <= 1e-5


def launches():
    return {**cuda_fusion.LAUNCHES, **cuda_texthead.LAUNCHES}


def test_graphed_train_epoch_is_the_eager_steps(device):
    """One row an epoch (each step's terms read); the learning rate set
    between two epochs replays the same capture (no wrapper launches), and
    dropping the gradients (``zero_grad``) makes the epoch capture again."""
    cfg = MopoeConfig(**KW)
    store = store_of(cfg, device)
    sd = create_train_state(cfg, device, seed=1).model.state_dict()
    graphed, eager = (create_train_state(cfg, device, state_dict=sd, seed=2) for _ in range(2))
    train_epoch, train_step = make_train_epoch(cfg, store), make_train_step(cfg)
    rows = epoch_index_matrix(store, 0, cfg.batch_size)
    assert len(rows) == 8
    for i, row in enumerate(rows):
        if i == 3:
            for state in (graphed, eager):
                set_learning_rate(state, 2e-4)
        if i == 5:
            for state in (graphed, eager):
                state.optimizer.zero_grad()
        before = launches()
        torch.cuda.manual_seed(10 + i)  # dropout's generator
        _, means = train_epoch(graphed, row[None])
        captured = launches() != before
        assert captured == (i in (0, 5)), (i, captured)
        torch.cuda.manual_seed(10 + i)
        assert_terms_close(means, train_step(eager, store.gather(row)))
        assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    assert graphed.step == eager.step == len(rows)
    assert_params_close(graphed, eager)


def test_graphed_epoch_means_are_the_eager_means(device):
    cfg = MopoeConfig(**KW)
    store = store_of(cfg, device)
    sd = create_train_state(cfg, device, seed=3).model.state_dict()
    graphed, eager = (create_train_state(cfg, device, state_dict=sd, seed=4) for _ in range(2))
    rows = epoch_index_matrix(store, 1, cfg.batch_size)
    torch.cuda.manual_seed(5)
    _, means = make_train_epoch(cfg, store)(graphed, rows)
    torch.cuda.manual_seed(5)
    step = make_train_step(cfg)
    ref = [{k: float(v) for k, v in loss_terms(step(eager, store.gather(r))).items()}
           for r in rows]
    for k, v in loss_terms(means).items():
        np.testing.assert_allclose(v, np.mean([t[k] for t in ref]), rtol=1e-5, err_msg=k)
    assert_params_close(graphed, eager)


def test_graphed_eval_epoch_is_the_per_step_eval(device):
    cfg = MopoeConfig(**KW)
    store = store_of(cfg, device)
    state = create_train_state(cfg, device, seed=6)
    rows = epoch_index_matrix(store, 0, cfg.batch_size)
    eval_epoch, eval_step = make_eval_epoch(cfg, store), make_eval_step(cfg)
    for epoch in range(2):  # the second call replays the first's capture
        g_epoch = torch.Generator(device).manual_seed(epoch)
        g_loop = torch.Generator(device).manual_seed(epoch)
        out, means = eval_epoch(state, g_epoch, rows)
        ref = [{k: float(v) for k, v in loss_terms(eval_step(state, store.gather(r),
                                                             g_loop)).items()} for r in rows]
        assert out is g_epoch and torch.equal(g_epoch.get_state(), g_loop.get_state())
        for k, v in loss_terms(means).items():
            np.testing.assert_allclose(v, np.mean([t[k] for t in ref]), rtol=1e-5, err_msg=k)


def test_an_uncapturable_step_raises(device, monkeypatch):
    """No eager fallback on the card: a step that waits for the host makes
    the epoch raise, with the state as it was. Last in the file: a failed
    capture may leave the capture stream's memory pool open."""
    cfg = MopoeConfig(**KW)
    store = store_of(cfg, device)
    state = create_train_state(cfg, device, seed=7)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    plain = losses.laplace_log_prob

    def waits(*args):
        torch.cuda.synchronize()
        return plain(*args)

    monkeypatch.setattr(losses, "laplace_log_prob", waits)
    with pytest.raises(RuntimeError):
        make_train_epoch(cfg, store)(state, epoch_index_matrix(store, 0, cfg.batch_size))
    assert state.step == 0
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k
