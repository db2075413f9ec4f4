"""The port's fused text vocab head (mopoe_mimic_tpu_torch/ops/texthead.py)
against the JAX package's (ops/pallas_texthead.py), float32 on the CPU.

The port's plain forward/backward pair is the oracle of the CUDA kernels
K2, so it is held against the Pallas kernels in interpret mode (as
tests/test_pallas_texthead.py runs them), on that file's shapes and
tolerances: values rtol 1e-5 and atol 1e-5, gradients rtol 1e-4 and atol
1e-5. The explicit backward is also held against torch.autograd of the
unfused reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mopoe_mimic_tpu.ops.pallas_texthead import fused_text_logprob as jax_fused
from mopoe_mimic_tpu.ops.pallas_texthead import reference_text_logprob as jax_reference
from mopoe_mimic_tpu_torch.ops import texthead as TH
from mopoe_mimic_tpu_torch.ops.cuda_texthead import texthead_cuda


def _case(B, L, C, V, seed=0):
    """test_pallas_texthead.py's inputs, as numpy: h, kernel [1, C, V],
    bias, targets with token 0 and V − 1 forced in."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, L, C)).astype(np.float32)
    kernel = (rng.normal(size=(1, C, V)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(V,)) * 0.1).astype(np.float32)
    targets = rng.integers(0, V, size=(B, L)).astype(np.int32)
    targets[0, 0], targets[0, -1] = 0, V - 1
    return h, kernel, bias, targets


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,L,C,V", [(4, 128, 64, 3517), (3, 17, 10, 37), (2, 256, 128, 128)])
def test_forward_matches_jax(B, L, C, V):
    case = _case(B, L, C, V)
    got = TH.fused_text_logprob(*_torch(*case))
    ref = jax_fused(*map(jnp.asarray, case), interpret=True)
    assert got.shape == (B, L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(TH.reference_text_logprob(*_torch(*case)).numpy(),
                               np.asarray(jax_reference(*map(jnp.asarray, case))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,L,C,V", [(3, 32, 24, 301), (3, 17, 10, 37)])
def test_gradients_match_jax(B, L, C, V):
    h, kernel, bias, targets = _case(B, L, C, V, seed=1)
    w = np.random.default_rng(2).normal(size=(B, L)).astype(np.float32)

    def jax_loss(h, k, b):
        return jnp.sum(w * jax_fused(h, k, b, jnp.asarray(targets), interpret=True))

    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (h, kernel, bias)))
    x = [t.requires_grad_() for t in _torch(h, kernel, bias)]
    lp = TH.fused_text_logprob(x[0], x[1], x[2], torch.from_numpy(targets))
    got = torch.autograd.grad((torch.from_numpy(w) * lp).sum(), x)
    for g, r, name in zip(got, ref, ("dh", "dkernel", "dbias")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5, err_msg=name)


def test_explicit_backward_matches_autograd():
    """The plain pair's backward (what the CUDA kernels compute) against
    autograd of the unfused float32 reference."""
    h, kernel, bias, targets = _case(3, 32, 24, 301, seed=3)
    h2, k2, b2 = (torch.from_numpy(h.reshape(-1, 24)), torch.from_numpy(kernel[0]),
                  torch.from_numpy(bias))
    t2 = torch.from_numpy(targets.reshape(-1))
    g = torch.from_numpy(np.random.default_rng(4).normal(size=(96,)).astype(np.float32))
    lp, lse = TH.texthead_fwd_plain(h2, k2, b2, t2)
    got = TH.texthead_bwd_plain(h2, k2, b2, t2, lse, g)
    x = [t.clone().requires_grad_() for t in (h2, k2, b2)]
    ref = torch.autograd.grad((g * TH.reference_text_logprob(*x, t2)).sum(), x)
    torch.testing.assert_close(lp, TH.reference_text_logprob(h2, k2, b2, t2), rtol=1e-5, atol=1e-5)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-5)
    # float64 accumulation (the oracle chip_smoke.py uses for long sums)
    got64 = TH.texthead_bwd_plain(h2, k2, b2, t2, lse, g, acc_dtype=torch.float64)
    for a, r in zip(got64[1:], got[1:]):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a.float(), r, rtol=1e-4, atol=1e-5)


def test_bf16_inputs_match_jax():
    """bfloat16 h and kernel, float32 accumulation on both sides; dh comes
    back in bfloat16, dW rounded to the kernel's dtype as JAX rounds it."""
    h, kernel, bias, targets = _case(4, 128, 64, 3517, seed=5)
    ref = jax_fused(jnp.asarray(h, jnp.bfloat16), jnp.asarray(kernel), jnp.asarray(bias),
                    jnp.asarray(targets), interpret=True)
    hb = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    got = TH.fused_text_logprob(hb, torch.from_numpy(kernel), torch.from_numpy(bias),
                                torch.from_numpy(targets))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    got.sum().backward()
    assert hb.grad.dtype == torch.bfloat16 and torch.isfinite(hb.grad.float()).all()


def test_targets_with_trailing_axis_and_kernel_shapes():
    h, kernel, bias, targets = _case(2, 8, 6, 11, seed=6)
    base = TH.fused_text_logprob(*_torch(h, kernel, bias, targets))
    flat = TH.fused_text_logprob(*_torch(h, kernel[0], bias, targets[..., None]))
    torch.testing.assert_close(base, flat, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    h, kernel, bias, targets = _case(2, 8, 6, 11, seed=7)
    with pytest.raises(ValueError, match="not a CUDA device"):
        texthead_cuda(torch.from_numpy(h.reshape(16, 6)), torch.from_numpy(kernel[0]),
                      torch.from_numpy(bias), torch.from_numpy(targets.reshape(16)))


def test_chip_smoke_k2_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's K2 phase (the checks against the plain pair, the
    two-run determinism check, timings, bounds, the unfused head) with the
    plain versions standing in for the kernels, at small shapes on the CPU:
    the bfloat16 dW as partials of two row splits and their finalize."""
    import warnings

    import chip_smoke

    ct = chip_smoke.cuda_texthead

    def partials(h, k, b, t, lse, g):
        halves = [TH.texthead_bwd_plain(h[rows], k, b, t[rows], lse[rows], g[rows])[1:]
                  for rows in (slice(0, len(h) // 2), slice(len(h) // 2, None))]
        return torch.stack([dw for dw, _ in halves]), torch.stack([db for _, db in halves])

    def finalize(part_dw, part_db):
        return part_dw.sum(0), part_db.sum(0)

    monkeypatch.setattr(ct, "texthead_fwd_cuda", TH.texthead_fwd_plain)
    monkeypatch.setattr(ct, "texthead_bwd_dh_cuda",
                        lambda *a: TH.texthead_bwd_plain(*a)[0])
    monkeypatch.setattr(ct, "texthead_bwd_dw_partials_cuda", partials)
    monkeypatch.setattr(ct, "texthead_bwd_dw_finalize_cuda", finalize)
    monkeypatch.setattr(ct, "texthead_bwd_dw_cuda", lambda *a: finalize(*partials(*a)))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, calls=1, warmup=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "sm_max_clock_hz", lambda: 1.98e9)
    monkeypatch.setattr(chip_smoke, "FLAGSHIP_HEAD", (2, 8, 16, 40))
    monkeypatch.setattr(chip_smoke, "K2_CASES", (((3, 17, 10, 37), torch.float32),
                                                 ((3, 17, 10, 37), torch.bfloat16),
                                                 ((2, 8, 16, 40), torch.bfloat16)))
    autocast = torch.autocast  # the card's bf16 autocast, on the CPU
    monkeypatch.setattr(torch, "autocast", lambda device_type, dtype=None, **kw: autocast(
        "cpu", dtype=dtype, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = chip_smoke.k2_against_plain(torch.device("cpu"), "a card, 700 W")
    keys = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    names = {n for n, (src, _) in chip_smoke.KERNELS.items() if src == chip_smoke.K2_SOURCE}
    assert set(out) == names and all(keys <= set(v) for v in out.values())
    assert all(v["library_ms"] is None for v in out.values())
    assert out["texthead_fwd"]["head_ms"].keys() == {"fused_fwd", "fused_fwd_bwd",
                                                     "unfused_fwd", "unfused_fwd_bwd"}
    assert out["texthead_bwd_dw"]["splits"] == 2 and out["texthead_bwd_dw"]["partials_ms"] == 1.0
    # dW's bound at R = 16, C = 16, V = 40: two products at the bf16 peak,
    # R·V exponentials on the SFUs, against h, W (bf16), b, t, lse, g read
    # and dW, db written once
    R, C, V = 16, 16, 40
    moved = R * C * 2 + C * V * 2 + V * 4 + R * 4 * 3 + (C * V + V) * 4
    assert out["texthead_bwd_dw"]["bound_ms"] == pytest.approx(max(
        moved / chip_smoke.HBM_BYTES_PER_S, 2 * 2 * R * C * V / 989e12,
        R * V / (132 * 16 * 1.98e9)) * 1e3)
    assert out["texthead_bwd_dw"]["bound_by"] == "bytes"
    assert out["texthead_bwd_dw_finalize"]["bound_ms"] == pytest.approx(
        (C * V + V) * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_chip_smoke_bounds_count_exponentials(monkeypatch):
    """least_time at the flagship head (R = 32768, C = 64, V = 3517, bf16):
    the forward's R·V exponentials on the SFUs (132 SMs × 16 a clock at
    1980 MHz) outweigh its product at the bf16 peak; each backward kernel's
    two products outweigh its exponentials; no exponentials, no third term."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "sm_max_clock_hz", lambda: 1.98e9)
    R, C, V = 32768, 64, 3517
    moved = R * C * 2 + C * V * 2 + V * 4 + R * 4 * 3
    fwd = chip_smoke.least_time(moved, 2 * R * C * V, torch.bfloat16, R * V)
    assert fwd["bound_by"] == "exponentials"
    assert fwd["bound_ms"] == pytest.approx(R * V / (132 * 16 * 1.98e9) * 1e3)
    assert 0.0275 < fwd["bound_ms"] < 0.0277
    bwd = chip_smoke.least_time(moved, 4 * R * C * V, torch.bfloat16, R * V)
    assert bwd["bound_by"] == "operations"
    assert bwd["bound_ms"] == pytest.approx(4 * R * C * V / 989e12 * 1e3)
    assert chip_smoke.least_time(moved, 2 * R * C * V, torch.bfloat16) == {
        "bound_ms": pytest.approx(2 * R * C * V / 989e12 * 1e3), "bound_by": "operations"}


FWD_TC = "_Z15texthead_fwd_tcILi4ELi16EEvPK13__nv_bfloat16"
DH_TC = "_Z18texthead_bwd_dh_tcILi4ELi2EEvPK13__nv_bfloat16"
DW_TC = "_Z18texthead_bwd_dw_tcILi4ELb1EEv"
PW_FWD_TC = "_ZN45_GLOBAL__N__12_pointwise_cu16pointwise_fwd_tcIfLi1EEEvPKT_"
PW_RED_TC = "_ZN45_GLOBAL__N__12_pointwise_cu23pointwise_bwd_reduce_tcIfLi1EEEvPKT_"
PW_DX_TC = "_ZN45_GLOBAL__N__12_pointwise_cu19pointwise_bwd_dx_tcIfLi2ELi16EEEvPKT_"


def _fake_build(monkeypatch, tmp_path, sass):
    """chip_smoke's phase 2 fed a build log in ptxas -v's format and a SASS
    listing in cuobjdump -sass's."""
    import subprocess

    import chip_smoke

    log = tmp_path / "lib.log"
    log.write_text("\n".join([
        f"ptxas info    : Compiling entry function '{FWD_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {FWD_TC}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{DH_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {DH_TC}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 246 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{DW_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {DW_TC}",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 127 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{PW_FWD_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {PW_FWD_TC}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 149 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{PW_RED_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {PW_RED_TC}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{PW_DX_TC}' for 'sm_90a'",
        f"ptxas info    : Function properties for {PW_DX_TC}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_Z19texthead_fwd_kernelIfEv' for 'sm_90a'",
        "ptxas info    : Used 120 registers, used 1 barriers"]))
    monkeypatch.setattr(chip_smoke._build, "build_log_path", lambda: log)
    monkeypatch.setattr(chip_smoke._build, "_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 0, stdout=sass, stderr=""))
    return chip_smoke


SASS = "\n".join([
    f"        Function : {FWD_TC}", "        /*0a00*/  HMMA.16816.F32.BF16 R24, R100, R4, R24 ;",
    "        /*0a10*/  MUFU.EX2 R3, R3 ;",
    "        /*0a20*/  HMMA.16816.F32.BF16 R28, R100, R6, R28 ;",
    "        /*0a30*/  HMMA.16816.F32.BF16 R32, R100, R8, R32 ;",
    f"        Function : {DH_TC}", "        /*0a70*/  HMMA.16816.F32.BF16 R24, R100, R4, R24 ;",
    "        /*0a80*/  HMMA.16816.F32.BF16 R28, R100, R6, R28 ;",
    f"        Function : {DW_TC}", "        /*0b00*/  HMMA.16816.F32.BF16 R8, R12, R4, R8 ;",
    f"        Function : {PW_FWD_TC}", "        /*0c00*/  HMMA.16816.F32.BF16 R8, R12, R4, R8 ;",
    f"        Function : {PW_RED_TC}", "        /*0d00*/  HMMA.16816.F32.BF16 R8, R12, R4, R8 ;",
    "        /*0d10*/  HMMA.16816.F32.BF16 R8, R12, R6, R8 ;",
    f"        Function : {PW_DX_TC}", "        /*0e00*/  HMMA.16816.F32.BF16 R8, R12, R4, R8 ;",
    "        Function : _Z19texthead_fwd_kernelIfEv",
    "        /*0010*/  FFMA R1, R2, R3, R1 ;"])


def test_chip_smoke_reads_registers_spills_and_tensor_core_instructions(monkeypatch, tmp_path):
    """Phase 2's report, from a build log and a SASS listing in the formats
    of ptxas -v and cuobjdump -sass; a kernel without HMMA fails."""
    chip_smoke = _fake_build(monkeypatch, tmp_path, SASS)
    got = chip_smoke.kernel_resources("lib.so")
    assert set(got) == set(chip_smoke.TENSOR_CORE_KERNELS)
    assert got["texthead_fwd_tc"] == {FWD_TC: {"registers": 168, "tensor_core_instructions": 3,
                                               "stack_bytes": 0, "spill_store_bytes": 0,
                                               "spill_load_bytes": 0}}
    assert got["texthead_bwd_dh_tc"][DH_TC] == {"registers": 246, "tensor_core_instructions": 2,
                                                "stack_bytes": 0, "spill_store_bytes": 0,
                                                "spill_load_bytes": 0}
    assert got["texthead_bwd_dw_tc"][DW_TC]["tensor_core_instructions"] == 1
    assert got["texthead_bwd_dw_tc"][DW_TC]["spill_store_bytes"] == 4
    assert got["pointwise_fwd_tc"][PW_FWD_TC]["registers"] == 149
    assert got["pointwise_bwd_reduce_tc"] == {PW_RED_TC: {
        "registers": 255, "tensor_core_instructions": 2, "stack_bytes": 0,
        "spill_store_bytes": 0, "spill_load_bytes": 0}}
    assert got["pointwise_bwd_dx_tc"] == {PW_DX_TC: {
        "registers": 90, "tensor_core_instructions": 1, "stack_bytes": 0,
        "spill_store_bytes": 0, "spill_load_bytes": 0}}
    _fake_build(monkeypatch, tmp_path, SASS.replace("HMMA", "FFMA"))
    with pytest.raises(chip_smoke.SmokeFailure, match="HMMA"):
        chip_smoke.kernel_resources("lib.so")


@pytest.mark.parametrize("mangled", [FWD_TC, DH_TC, DW_TC, PW_FWD_TC, PW_RED_TC, PW_DX_TC])
def test_chip_smoke_fails_a_tensor_core_kernel_without_hmma(monkeypatch, tmp_path, mangled):
    """One instantiation whose SASS has no HMMA (here each kernel's in turn,
    the new forward's among them) fails phase 2, naming it."""
    lines = SASS.splitlines()
    at = lines.index(f"        Function : {mangled}")
    end = next((i for i in range(at + 1, len(lines)) if "Function :" in lines[i]), len(lines))
    sass = "\n".join(lines[:at + 1] + [x.replace("HMMA", "FFMA") for x in lines[at + 1:end]]
                     + lines[end:])
    chip_smoke = _fake_build(monkeypatch, tmp_path, sass)
    with pytest.raises(chip_smoke.SmokeFailure, match=f"{mangled}: no HMMA"):
        chip_smoke.kernel_resources("lib.so")
