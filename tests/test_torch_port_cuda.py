"""The hand-written CUDA kernels against their plain PyTorch versions on an
NVIDIA GPU: K1 (subset PoE) forward and backward, K2 (fused text head)
forward and backward, K3 (fused BN → ReLU → 1×1 conv) forward and both
backward passes.

Needs the card: marked ``cuda`` and skipped where CUDA is unavailable.
This file imports neither jax nor the JAX package, so it also runs where
they are absent; there, skip the repository's conftest (which loads jax):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerances: K1 forward 1e-6·max(1, |ref|) (the same operations in the
same order in float32, IEEE division, no fast-math, no FMA contraction:
bitwise equal on the card); K1 backward 1e-5·max(1, |ref|) (FMA
contraction in the kernel); K1's experts separate, strided or stacked.
K2 in float32 with TF32 off: lp rtol 1e-5 atol 1e-5, gradients
rtol 1e-4 atol 1e-5 (tests/test_pallas_texthead.py's bounds), against the
plain pair accumulated in float64; in bfloat16 against the plain pair fed
the same bfloat16 inputs: lp and lse |Δ| ≤ 1e-5·max(1, |ref|) (the forward
runs on tensor cores; bf16 × bf16 products are exact in float32, so only
the order of the sums and the SFU's ex2 differ), gradients
|Δ| ≤ 2e-2·max|ref| (the bfloat16 backward runs on tensor cores: the same
products in another order), and two runs bitwise equal. K3 in float32 with TF32 off against the plain
versions accumulated in float64: y and dx rtol 1e-5, dW, dcb, dγ, dβ rtol
1e-4, all atol 1e-5·max|ref|; in bfloat16 (the forward and both passes on
tensor cores) against the plain versions on the same inputs: y
|Δ| ≤ 1e-2·max|ref|, gradients |Δ| ≤ 2e-2·max|ref|. K3's statistics
against float64: mean and var |Δ| ≤ 1e-5·|ref| (the mean's floor
1e-6·sqrt(var)), inv within 1 ulp of 1/sqrt(var + eps), the running
buffers within rtol 1e-6, atol 1e-6·max|ref|, of the plain update.
"""

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

import chip_smoke

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.models.resblocks import ResidualBlock2dConv
from mopoe_mimic_tpu_torch.ops import cuda_fusion, cuda_pointwise, cuda_texthead
from mopoe_mimic_tpu_torch.ops import fusion as F
from mopoe_mimic_tpu_torch.ops import pointwise as PW
from mopoe_mimic_tpu_torch.ops import texthead as TH

pytestmark = pytest.mark.cuda

NAMES = ("PA", "Lateral", "text")


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 128, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_matches_plain(device, m, b, prior):
    rng = np.random.default_rng(10 * m + b)
    mus, lvs = _normal(rng, (m, b, 64), device), _normal(rng, (m, b, 64), device)
    mask = F.subset_mask_matrix(NAMES[:m])
    k_mu, k_lv = cuda_fusion.poe_subsets_cuda(mus, lvs, mask, prior_expert=prior)
    r_mu, r_lv = F.poe_subsets(mus, lvs, mask, prior_expert=prior)
    torch.cuda.synchronize()
    for got, ref in ((k_mu, r_mu), (k_lv, r_lv)):
        bound = 1e-6 * torch.clamp(ref.abs(), min=1.0)
        assert bool(((got - ref).abs() <= bound).all()), float((got - ref).abs().max())


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_backward_kernel_matches_plain_and_autograd(device, m, b, prior):
    """Gradients through the autograd.Function (the backward kernel)
    against the closed form and against autograd of the plain forward."""
    rng = np.random.default_rng(100 + 10 * m + b)
    mask = F.subset_mask_matrix(NAMES[:m])
    mus, lvs = _normal(rng, (m, b, 64), device), _normal(rng, (m, b, 64), device)
    cot = (_normal(rng, (mask.shape[0], b, 64), device),
           _normal(rng, (mask.shape[0], b, 64), device))
    x = (mus.clone().requires_grad_(), lvs.clone().requires_grad_())
    before = dict(cuda_fusion.LAUNCHES)
    got = torch.autograd.grad(cuda_fusion.poe_subsets_cuda(*x, mask, prior_expert=prior), x, cot)
    assert cuda_fusion.LAUNCHES["poe_subsets_bwd_f32"] == before["poe_subsets_bwd_f32"] + 1
    y = (mus.clone().requires_grad_(), lvs.clone().requires_grad_())
    refs = (F.poe_subsets_bwd(mus, lvs, *cot, mask, prior_expert=prior),
            torch.autograd.grad(F.poe_subsets(*y, mask, prior_expert=prior), y, cot))
    torch.cuda.synchronize()
    for ref in refs:
        for g, r in zip(got, ref):
            bound = 1e-5 * torch.clamp(r.abs(), min=1.0)
            assert bool(((g - r).abs() <= bound).all()), float((g - r).abs().max())


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("form", chip_smoke.K1_FORMS)
@pytest.mark.parametrize("d", chip_smoke.K1_DIMS)
@pytest.mark.parametrize("b", [1, 5, 256])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_k1_matches_plain_for_every_form_of_experts(device, m, b, d, form, prior):
    """The power-set kernels, forward and backward, on experts given as
    separate tensors, strided views and a stacked pair
    (``chip_smoke.k1_case``: its bounds and checks)."""
    rng = np.random.default_rng(1000 + 10 * m + b + d)
    mask = F.subset_mask_matrix(NAMES[:m])
    values = chip_smoke.k1_values(rng, m, b, d, device)
    got = chip_smoke.k1_case(values, mask, prior, form,
                             chip_smoke.k1_values(rng, mask.shape[0], b, d, device))
    assert got["bitwise"]  # the forward rounds as the plain version does


@pytest.mark.parametrize("form", chip_smoke.K1_FORMS)
def test_k1_backward_reads_the_experts_autograd_gives_back(device, form):
    """Under a saved-tensor hook the backward gets new tensors: it reads
    those, not the forward's experts, which are overwritten by NaN
    (``chip_smoke.k1_saved_hook_case``)."""
    rng = np.random.default_rng(7)
    chip_smoke.k1_saved_hook_case(chip_smoke.k1_values(rng, 3, 8, 64, device),
                                  F.subset_mask_matrix(NAMES), form,
                                  chip_smoke.k1_values(rng, 7, 8, 64, device))


def test_k1_under_non_reentrant_checkpoint(device):
    """K1 inside ``torch.utils.checkpoint`` (non-reentrant): the gradients
    of the recomputed forward equal those of a plain call, bitwise."""
    rng = np.random.default_rng(8)
    values = chip_smoke.k1_values(rng, 3, 32, 64, device)
    up = chip_smoke.k1_values(rng, 7, 32, 64, device)
    mask = F.subset_mask_matrix(NAMES)
    grads = []
    for checkpointed in (False, True):
        mus, lvs, leaves = chip_smoke.k1_experts(values, "separate", grad=True)

        def fused(*xs):
            return cuda_fusion.poe_subsets_cuda(xs[:3], xs[3:], mask)

        out = (torch.utils.checkpoint.checkpoint(fused, *leaves, use_reentrant=False)
               if checkpointed else fused(*leaves))
        grads.append(torch.autograd.grad(out, leaves, up))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.parametrize("mask_index", range(4))
def test_k1_generic_layouts_match_plain(device, mask_index):
    mask = chip_smoke.k1_generic_masks()[mask_index]
    m = mask.shape[1]
    assert cuda_fusion.kernel_layout(mask, m).masks is not None
    rng = np.random.default_rng(mask_index)
    for form in ("separate", "stacked"):
        values = chip_smoke.k1_values(rng, m, 37, 64, device)
        chip_smoke.k1_case(values, mask, True, form,
                           chip_smoke.k1_values(rng, mask.shape[0], 37, 64, device))


def _inference_case(device, method="joint_elbo"):
    cfg = MopoeConfig(method=method, img_size=64, DIM_img=4, DIM_text=4, class_dim=4,
                      text_encoding="word", vocab_size=30, batch_size=4,
                      compute_dtype="float32")
    torch.manual_seed(0)
    model = MMVae(cfg).to(device)
    rng = np.random.default_rng(0)
    batch = {"PA": rng.random((4, 1, 64, 64), dtype=np.float32),
             "Lateral": rng.random((4, 1, 64, 64), dtype=np.float32),
             "text": rng.integers(0, 30, (4, 128))}
    return cfg, model, {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@pytest.mark.parametrize("grad", [False, True])
def test_inference_launches_k1_once_a_call(device, grad, monkeypatch):
    """MMVae.inference on the card: one poe_subsets_f32 launch a call, with
    or without a gradient to record, and one poe_subsets_bwd_f32 launch a
    backward; equal results every call (the subset layout and the kernel's
    masks come from their caches)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg, model, batch = _inference_case(device)
    model.eval()
    outs = []
    for _ in range(3):
        before = dict(cuda_fusion.LAUNCHES)
        with torch.set_grad_enabled(grad):
            outs.append(model.inference(batch))
        assert cuda_fusion.LAUNCHES["poe_subsets_f32"] == before["poe_subsets_f32"] + 1
        if grad:
            out = outs[-1]
            loss = sum(mu.sum() + lv.sum() for mu, lv in out["subsets"].values())
            (loss + out["joint"][0].sum()).backward()
        assert cuda_fusion.LAUNCHES["poe_subsets_bwd_f32"] == before["poe_subsets_bwd_f32"] + grad
    assert list(outs[0]["subsets"]) == list(F.subset_powerset(cfg.modality_names))
    for out in outs[1:]:
        for key, (mu, lv) in outs[0]["subsets"].items():
            assert torch.equal(out["subsets"][key][0], mu)
            assert torch.equal(out["subsets"][key][1], lv)
        assert all(torch.equal(a, b) for a, b in zip(out["joint"], outs[0]["joint"]))


@pytest.mark.parametrize("method", ["joint_elbo", "poe", "moe", "jsd"])
def test_inference_and_backward_do_not_synchronize(device, method):
    """MMVae.inference in train mode and its backward, after a first call
    (which builds the cached indices), raise nothing under PyTorch's sync
    debug mode "error": the latent block never waits for the host."""
    _, model, batch = _inference_case(device, method)
    model.train()
    model.inference(batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = model.inference(batch)
        loss = sum(mu.sum() + lv.sum() for mu, lv in out["subsets"].values())
        (loss + out["joint"][0].sum() + out["mus"].sum()).backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_k1_launch_failure_raises(device, monkeypatch):
    """A launch the kernels refuse raises; nothing falls back to the plain
    version: the power-set layout asked of 4 experts (the kernels are built
    for M <= 3), forward and backward."""
    values = chip_smoke.k1_values(np.random.default_rng(0), 3, 8, 64, device)
    mask = F.subset_mask_matrix(NAMES)
    mus, lvs, _ = chip_smoke.k1_experts(values, "separate")
    up = chip_smoke.k1_values(np.random.default_rng(1), 7, 8, 64, device)
    call = cuda_fusion._call
    monkeypatch.setattr(cuda_fusion, "_call",
                        lambda *args: call(*args)._replace(n_experts=4))
    before = dict(cuda_fusion.LAUNCHES)
    with pytest.raises(RuntimeError, match="poe_subsets_f32 launch failed"):
        cuda_fusion.poe_subsets_cuda(mus, lvs, mask)
    with pytest.raises(RuntimeError, match="poe_subsets_bwd_f32 launch failed"):
        cuda_fusion.poe_subsets_bwd_cuda(mus, lvs, *up, mask)
    assert cuda_fusion.LAUNCHES == before  # a refused launch is not counted


def test_kernel_refuses_what_it_does_not_take(device):
    mask = F.subset_mask_matrix(NAMES)
    x = torch.zeros((3, 4, 8), device=device)
    with pytest.raises(TypeError):
        cuda_fusion.poe_subsets_cuda(x.double(), x.double(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_fusion.poe_subsets_cuda(x.transpose(1, 2), x.transpose(1, 2), mask)


def _k2_case(device, B, L, C, V, dtype, seed):
    rng = np.random.default_rng(seed)
    targets = rng.integers(0, V, size=(B * L,))
    targets[0], targets[-1] = 0, V - 1
    return (torch.from_numpy(rng.normal(size=(B * L, C))).to(device, dtype),
            torch.from_numpy(rng.normal(size=(C, V)) * 0.1).to(device, dtype),
            torch.from_numpy(rng.normal(size=(V,)) * 0.1).to(device, torch.float32),
            torch.from_numpy(targets).to(device, torch.int32),
            torch.from_numpy(rng.normal(size=(B * L,))).to(device, torch.float32))


@pytest.mark.parametrize("shape", [(3, 17, 10, 37), (4, 128, 64, 3517), (2, 64, 128, 300),
                                   (256, 128, 64, 3517)])
def test_texthead_kernels_match_plain_f32(device, shape):
    h, k, b, t, g = _k2_case(device, *shape, torch.float32, seed=sum(shape))
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    dh = cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g)
    dw, db = cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g)
    r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t, torch.float64)
    refs = TH.texthead_bwd_plain(h, k, b, t, r_lse, g, torch.float64)
    torch.cuda.synchronize()
    for got, ref in ((lp, r_lp), (lse, r_lse)):
        torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    for got, ref in zip((dh, dw, db), refs):
        torch.testing.assert_close(got.double(), ref.double(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 17, 10, 37), (3, 32, 24, 301), (2, 64, 128, 300),
                                   (256, 128, 64, 3517)])
def test_texthead_kernels_match_plain_bf16(device, shape):
    """bfloat16: the backward on tensor cores, at ragged rows, vocabulary
    and channels, at C = 128 and at the flagship."""
    h, k, b, t, g = _k2_case(device, *shape, torch.bfloat16, seed=9)
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    dh = cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g)
    dw, db = cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g)
    r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t)
    refs = TH.texthead_bwd_plain(h, k, b, t, r_lse, g)
    torch.cuda.synchronize()
    assert bool(((lp - r_lp).abs() <= 1e-3 * torch.clamp(r_lp.abs(), min=1.0)).all())
    for got, ref in zip((dh, dw, db), refs):
        err = (got.float() - ref.float()).abs().max()
        assert float(err) <= 2e-2 * float(ref.float().abs().max())


def _k2_fwd_case(device, R, C, V, equal_bias, seed):
    """bf16 forward inputs with rows that probe the online logsumexp: the
    targets of rows 0 and R − 1 at columns 0 and V − 1; row 1 all equal
    logits where the bias is constant (h = 0); row 2 with its maximum at
    column V − 1, in the ragged last vocabulary tile where V % 64 != 0."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(R, C))
    w = rng.normal(size=(C, V)) * 0.1
    b = np.full((V,), 0.25) if equal_bias else rng.normal(size=(V,)) * 0.1
    t = rng.integers(0, V, size=(R,))
    t[0], t[-1] = 0, V - 1
    h[1] = 0.0
    w[:, V - 1] = 1.0
    h[2] = 1.0
    return (torch.from_numpy(h).to(device, torch.bfloat16),
            torch.from_numpy(w).to(device, torch.bfloat16),
            torch.from_numpy(b).to(device, torch.float32),
            torch.from_numpy(t).to(device, torch.int32))


@pytest.mark.parametrize("equal_bias", [False, True])
@pytest.mark.parametrize("R,C,V", [(51, 10, 37), (257, 24, 300), (1000, 64, 3517),
                                   (129, 128, 300), (4099, 128, 3517), (32768, 64, 3517),
                                   (32768 + 77, 64, 37)])
def test_texthead_fwd_bf16_matches_plain(device, R, C, V, equal_bias):
    """The tensor-core forward against the plain pair on the same bf16
    inputs: R not a multiple of the block's rows, V = 37, 300 and 3517 (odd:
    W's rows off 4-byte alignment), C = 10, 24, 64, 128; two runs bitwise
    equal."""
    h, k, b, t = _k2_fwd_case(device, R, C, V, equal_bias, seed=R + C + V)
    before = cuda_texthead.LAUNCHES["texthead_fwd"]
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    again = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    assert cuda_texthead.LAUNCHES["texthead_fwd"] == before + 2
    r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t)
    torch.cuda.synchronize()
    assert torch.equal(lp, again[0]) and torch.equal(lse, again[1])
    for got, ref in ((lp, r_lp), (lse, r_lse)):
        err = (got.double() - ref.double()).abs()
        assert bool((err <= 1e-5 * ref.double().abs().clamp(min=1.0)).all()), float(err.max())
    assert int((h[2].float() @ k.float() + b).argmax()) == V - 1  # row 2's maximum, last tile
    if equal_bias:  # row 1: V equal logits
        assert abs(float(lse[1]) - (0.25 + np.log(V))) <= 1e-5 * (0.25 + np.log(V))


def test_texthead_fwd_bf16_refuses_a_misaligned_kernel(device):
    """No fallback: the tensor-core forward reads W as 4-byte words, and a W
    that starts off that alignment is refused by the launch itself."""
    h, k, b, t = _k2_fwd_case(device, 16, 16, 40, False, seed=2)
    odd = torch.zeros(16 * 40 + 1, device=device, dtype=torch.bfloat16)[1:].view(16, 40)
    odd.copy_(k)
    before = cuda_texthead.LAUNCHES["texthead_fwd"]
    with pytest.raises(RuntimeError, match="texthead_fwd launch failed"):
        cuda_texthead.texthead_fwd_cuda(h, odd, b, t)
    assert cuda_texthead.LAUNCHES["texthead_fwd"] == before


def test_texthead_backward_is_deterministic(device):
    """No atomics: dW and db's row splits are summed in a fixed order."""
    h, k, b, t, g = _k2_case(device, 256, 128, 64, 3517, torch.bfloat16, seed=11)
    _, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    runs = [(cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g),
             *cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g)) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_fused_text_logprob_gradients_through_the_kernels(device):
    """fused_text_logprob on CUDA tensors launches the three kernels and its
    gradients equal autograd of the unfused reference."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.normal(size=(3, 32, 24)).astype(np.float32)).to(device)
    k = torch.from_numpy((rng.normal(size=(24, 301)) * 0.1).astype(np.float32)).to(device)
    b = torch.from_numpy((rng.normal(size=(301,)) * 0.1).astype(np.float32)).to(device)
    t = torch.from_numpy(rng.integers(0, 301, (3, 32))).to(device)
    w = torch.from_numpy(rng.normal(size=(3, 32)).astype(np.float32)).to(device)
    x = [a.clone().requires_grad_() for a in (h, k, b)]
    before = dict(cuda_texthead.LAUNCHES)
    got = torch.autograd.grad((w * TH.fused_text_logprob(*x, t)).sum(), x)
    # float32: dW has no row splits, so no finalize
    added = {n: cuda_texthead.LAUNCHES[n] - before[n] for n in before}
    assert added == {"texthead_fwd": 1, "texthead_bwd_dh": 1, "texthead_bwd_dw": 1,
                     "texthead_bwd_dw_finalize": 0}
    y = [a.clone().requires_grad_() for a in (h, k, b)]
    ref = torch.autograd.grad((w * TH.reference_text_logprob(*y, t)).sum(), y)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)


def test_fused_text_logprob_bf16_launches_the_finalize(device):
    h, k, b, t, g = _k2_case(device, 3, 32, 24, 301, torch.bfloat16, seed=4)
    x = [a.clone().requires_grad_() for a in (h.reshape(3, 32, 24), k.float(), b)]
    before = dict(cuda_texthead.LAUNCHES)
    torch.autograd.grad((g.reshape(3, 32) * TH.fused_text_logprob(*x, t.reshape(3, 32))).sum(), x)
    assert all(cuda_texthead.LAUNCHES[n] == before[n] + 1 for n in before)


def test_texthead_refuses_what_it_does_not_take(device):
    h, k, b, t, _ = _k2_case(device, 2, 8, 16, 40, torch.float32, seed=1)
    with pytest.raises(TypeError):
        cuda_texthead.texthead_cuda(h, k.to(torch.bfloat16), b, t)
    with pytest.raises(ValueError, match="channels"):
        wide = torch.zeros((16, 129), device=device)
        cuda_texthead.texthead_cuda(wide, torch.zeros((129, 40), device=device), b, t)
    with pytest.raises(ValueError, match="different devices"):
        TH.fused_text_logprob(h.reshape(2, 8, 16), k.cpu(), b, t.reshape(2, 8))
    with pytest.raises(ValueError, match="4-byte aligned"):
        odd = torch.zeros(16 * 40 + 1, device=device, dtype=torch.bfloat16)[1:].view(16, 40)
        cuda_texthead.texthead_cuda(h.to(torch.bfloat16), odd, b, t)


def _k3_case(device, B, C, Co, S, x_dtype, w_dtype, transpose=False, bias=True, seed=0):
    return chip_smoke.k3_case(device, B, C, Co, (S,), bias, transpose, x_dtype, w_dtype, seed)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("B,C,Co,S", [(3, 64, 64, 25), (2, 48, 40, 7), (256, 320, 320, 1),
                                      (4, 320, 320, 16), (8, 256, 256, 64), (5, 3, 130, 33)])
def test_pointwise_kernels_match_plain_f32(device, B, C, Co, S, transpose):
    args = _k3_case(device, B, C, Co, S, torch.float32, torch.float32, transpose, seed=B + C + S)
    got = chip_smoke.k3_run(args)
    ref = chip_smoke.k3_plain(args, torch.float64)
    torch.cuda.synchronize()
    for a, r, rtol in zip(got, ref, (1e-5, 1e-5, 1e-4, 1e-4, 1e-4, 1e-4)):
        torch.testing.assert_close(a.double(), r, rtol=rtol, atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,Co,S", [(256, 64, 64, 1024), (256, 320, 320, 16)])
def test_pointwise_kernels_match_plain_bf16(device, B, C, Co, S, x_dtype):
    args = _k3_case(device, B, C, Co, S, x_dtype, torch.bfloat16, seed=S)
    got = chip_smoke.k3_run(args)
    ref = chip_smoke.k3_plain(args)
    torch.cuda.synchronize()
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == x_dtype
    for a, r, frac in zip(got, ref, (1e-2,) + (2e-2,) * 5):
        err = (a.float() - r.float()).abs().max()
        assert float(err) <= frac * float(r.float().abs().max())


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,Co,S", [(5, 3, 130, 33), (2, 48, 40, 7), (7, 48, 40, 1),
                                      (256, 320, 320, 1), (3, 64, 80, 8), (9, 128, 72, 32),
                                      (2, 100, 64, 128), (13, 192, 192, 16), (5, 64, 64, 2)])
def test_pointwise_tc_kernels_match_plain_at_edges(device, B, C, Co, S, x_dtype):
    """The tensor-core forward and pass A (bfloat16 W) at C or Co not a
    multiple of 16, S = 1, S that neither divides nor is a multiple of the
    64-row unit (element-wise loads), and R = B·S not a multiple of any
    tile, against the plain versions on the same inputs."""
    for transpose in (False, True):
        args = _k3_case(device, B, C, Co, S, x_dtype, torch.bfloat16, transpose, seed=B + C + S)
        got = chip_smoke.k3_run(args)
        ref = chip_smoke.k3_plain(args)
        torch.cuda.synchronize()
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == x_dtype
        for a, r, frac in zip(got, (ref[0].to(torch.bfloat16),) + ref[1:], (1e-2,) + (2e-2,) * 5):
            err = (a.float() - r.float()).abs().max()
            assert float(err) <= frac * float(r.float().abs().max())


def test_pointwise_backward_is_deterministic(device):
    """No atomics: pass A's sums have a fixed order."""
    args = _k3_case(device, 64, 128, 128, 256, torch.bfloat16, torch.bfloat16, seed=1)
    first = chip_smoke.k3_run(args)
    second = chip_smoke.k3_run(args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_pointwise_tc_pass_a_is_bitwise_deterministic_over_chunks(device):
    """bfloat16 pass A at a C = 320 block of several row chunks: the
    partials and their finalize give bitwise equal dW, dcb, dγ, dβ."""
    args = _k3_case(device, 256, 320, 320, 16, torch.float32, torch.bfloat16, seed=2)
    assert cuda_pointwise.reduce_tc_chunks(256 * 16, 320, 320, 4)[1] > 1
    x3, g, b, m, inv, w, _, dy = args
    first = cuda_pointwise.pointwise_bwd_reduce_cuda(x3, g, b, m, inv, w, dy)
    second = cuda_pointwise.pointwise_bwd_reduce_cuda(x3, g, b, m, inv, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("w_dtype", [torch.bfloat16, torch.float32])
def test_pointwise_dispatches_on_the_weight_dtype(device, w_dtype):
    """A bfloat16 W launches the tensor-core forward and both passes, never
    the float32 CUDA-core kernels, and a float32 W the reverse; the fused
    op takes its statistics with ``pointwise_stats`` in both."""
    args = _k3_case(device, 4, 64, 64, 64, torch.float32, w_dtype, seed=3)
    before = dict(cuda_pointwise.LAUNCHES)
    chip_smoke.k3_run(args)
    added = {n: cuda_pointwise.LAUNCHES[n] - before[n] for n in before}
    tc = int(w_dtype == torch.bfloat16)
    assert added == {"pointwise_fwd": 1 - tc, "pointwise_fwd_tc": tc,
                     "pointwise_bwd_reduce": 1 - tc, "pointwise_bwd_reduce_tc": tc,
                     "pointwise_bwd_finalize": 1, "pointwise_bwd_dx": 1 - tc,
                     "pointwise_bwd_dx_tc": tc, "pointwise_stats": 0,
                     "pointwise_stats_finalize": 0}
    x3, g, b, _, _, w, cb, _ = args
    before = dict(cuda_pointwise.LAUNCHES)
    PW.fused_bn_relu_pointwise(x3, g, b, w, cb, 1e-5, w_dtype)
    added = {n: cuda_pointwise.LAUNCHES[n] - before[n] for n in before}
    assert added["pointwise_stats"] == added["pointwise_stats_finalize"] == 1


EDGES = [(5, 3, 130, 33), (2, 48, 40, 7), (7, 48, 40, 1), (256, 320, 320, 1), (3, 64, 80, 8),
         (9, 128, 72, 32), (2, 100, 64, 128), (13, 192, 192, 16), (5, 64, 64, 2)]


def _dx_twice(args):
    x3, g, b, m, inv, w, _, dy = args
    _, _, dg, db = cuda_pointwise.pointwise_bwd_reduce_cuda(x3, g, b, m, inv, w, dy)
    before = cuda_pointwise.LAUNCHES["pointwise_bwd_dx_tc"]
    dx = cuda_pointwise.pointwise_bwd_dx_cuda(x3, g, b, m, inv, w, dy, dg, db)
    again = cuda_pointwise.pointwise_bwd_dx_cuda(x3, g, b, m, inv, w, dy, dg, db)
    assert cuda_pointwise.LAUNCHES["pointwise_bwd_dx_tc"] == before + 2
    ref = PW.pointwise_bwd_dx_plain(x3, g, b, m, inv, w, dy, dg, db)
    torch.cuda.synchronize()
    assert dx.dtype == x3.dtype and torch.equal(dx, again)
    err = (dx.float() - ref.float()).abs().max()
    assert float(err) <= 2e-2 * float(ref.float().abs().max()), float(err)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,C,Co,S", EDGES)
def test_pointwise_dx_tc_matches_plain_at_edges(device, B, C, Co, S, x_dtype):
    """bfloat16 pass B (``pointwise_bwd_dx_tc``) at the forward's and pass
    A's edge shapes, both conv1 layouts: C or Co not a multiple of 16, S = 1,
    2, 8, 16, 32 (whole b a unit), 128 (runs along s), 7 and 33
    (element-wise loads), row tiles of 64, 32 and 16 rows; against the plain
    pass B on the same inputs, two runs bitwise equal."""
    for transpose in (False, True):
        _dx_twice(_k3_case(device, B, C, Co, S, x_dtype, torch.bfloat16, transpose,
                           seed=B + C + S))


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_pointwise_dx_tc_takes_unaligned_tensors(device, x_dtype):
    """x and dy that do not start on a 16-byte boundary go through the
    element-wise loads and stores."""
    x3, g, b, m, inv, w, cb, dy = _k3_case(device, 4, 64, 64, 64, x_dtype, torch.bfloat16, seed=5)

    def shifted(t):
        out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
        return out.copy_(t)

    _dx_twice((shifted(x3), g, b, m, inv, w, cb, shifted(dy)))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,S", [(256, 64, 4096), (256, 320, 1), (256, 256, 8), (3, 64, 25),
                                   (7, 3, 1), (5, 130, 33), (1, 2048, 1), (9, 48, 16),
                                   (2, 5, 1000)])
def test_pointwise_stats_matches_float64_and_is_deterministic(device, B, C, S, x_dtype):
    """``pointwise_stats`` + finalize at the flagship's largest, widest and a
    small-S block and at odd shapes (one chunk, odd C, S not a multiple of a
    16-byte group): against the float64 statistics, the running update
    against the plain update from the kernel's statistics, two runs from the
    same buffers bitwise equal; and from an x that is not 16-byte aligned."""
    gen = torch.Generator(device=device).manual_seed(B + C + S)
    x3 = (1.3 * torch.randn((B, C, S), generator=gen, device=device) + 0.2).to(x_dtype)
    start = chip_smoke.running_buffers(C, device, seed=S)
    shifted = torch.empty(x3.numel() + 1, dtype=x_dtype, device=device)[1:].view(x3.shape)
    shifted.copy_(x3)
    for x in (x3, shifted):
        runs = []
        for _ in range(2):
            running = (start[0].clone(), start[1].clone(), 0.1)
            runs.append((*cuda_pointwise.pointwise_stats_cuda(x, 1e-5, running), *running[:2]))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        mean, var, inv, rm, rv = runs[0]
        ref_var, ref_mean = torch.var_mean(x3.double(), dim=(0, 2), correction=0)
        assert bool(((mean.double() - ref_mean).abs()
                     <= 1e-5 * ref_mean.abs() + 1e-6 * ref_var.sqrt()).all())
        assert bool(((var.double() - ref_var).abs() <= 1e-5 * ref_var).all())
        want = 1.0 / torch.sqrt(var + 1e-5)
        assert int((inv.view(torch.int32) - want.view(torch.int32)).abs().max()) <= 1
        plain = (start[0].clone(), start[1].clone(), 0.1)
        PW.update_running_stats(*plain, mean, var, B * S)
        for got, ref in zip((rm, rv), plain):
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6 * float(ref.abs().max()))


def test_fused_block_on_cuda_launches_k3_and_matches_the_cpu(device):
    """A fused block on CUDA tensors goes through the kernels (never the
    plain version) and gives the CPU block's outputs, running statistics and
    gradients (float32, TF32 off)."""
    torch.manual_seed(0)
    cpu = ResidualBlock2dConv(32, 64, fused_pointwise=True)
    gpu = ResidualBlock2dConv(32, 64, fused_pointwise=True).to(device)
    gpu.load_state_dict(cpu.state_dict())
    for mod in (cpu, gpu):
        mod.dropout1.p = mod.dropout2.p = 0.0
    x = torch.randn(8, 32, 16, 16)
    before = dict(cuda_pointwise.LAUNCHES)
    outs = []
    for mod, dev in ((cpu, "cpu"), (gpu, device)):
        xi = x.to(dev).requires_grad_()
        y = mod(xi)
        grads = torch.autograd.grad(torch.tanh(y).sum(), [xi, *mod.parameters()])
        outs.append((y, grads, mod.bn1.running_mean, mod.bn1.running_var))
    # float32: the CUDA-core kernels, none of the bfloat16 tensor-core ones
    assert all(cuda_pointwise.LAUNCHES[n] == before[n] + (not n.endswith("_tc")) for n in before)
    (y_c, g_c, m_c, v_c), (y_g, g_g, m_g, v_g) = outs
    torch.testing.assert_close(y_g.cpu(), y_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(m_g.cpu(), m_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(v_g.cpu(), v_c, rtol=1e-5, atol=1e-6)
    # a shortcut bias in front of a train-mode BatchNorm has a zero gradient in
    # exact arithmetic: rounding noise on both sides, held to the model's scale
    g_max = max(float(r.abs().max()) for r in g_c)
    for a, r in zip(g_g, g_c):
        torch.testing.assert_close(a.cpu(), r, rtol=1e-3,
                                   atol=1e-3 * float(r.abs().max()) + 1e-5 * g_max)


def test_pointwise_refuses_what_it_does_not_take(device):
    x3, g, b, m, inv, w, cb, _ = _k3_case(device, 2, 16, 16, 8, torch.float32, torch.float32)
    with pytest.raises(TypeError):
        cuda_pointwise.pointwise_cuda(x3.double(), g, b, m, inv, w, cb)
    with pytest.raises(TypeError):
        cuda_pointwise.pointwise_cuda(x3, g.double(), b, m, inv, w, cb)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_pointwise.pointwise_cuda(x3.transpose(1, 2).contiguous().transpose(1, 2), g, b, m,
                                      inv, w, cb)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_pointwise.pointwise_cuda(x3.cpu(), g, b, m, inv, w, cb)
    with pytest.raises(ValueError, match="channels"):
        wide = torch.zeros((2, 4096, 8), device=device)
        z = torch.zeros(4096, device=device)
        cuda_pointwise.pointwise_cuda(wide, z, z, z, z, torch.zeros((4096, 4), device=device),
                                      torch.zeros(4, device=device))
    with pytest.raises(ValueError, match="different devices"):
        PW.fused_bn_relu_pointwise(x3, g, b, w.cpu(), None, 1e-5, torch.float32)
