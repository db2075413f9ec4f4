"""The port's fused BN → ReLU → 1×1 conv (K3, ``cfg.fused_pointwise``)
against the JAX package's, float32 on the CPU.

(a) The op: the port's plain forward, passes A and B and its autograd
    against ``fused_bn_relu_pointwise(..., interpret=True)`` and the VJP of
    its Pallas core, at tests/test_pallas_pointwise.py's shapes, with that
    file's bounds: y rtol 1e-5 (atol 1e-6 for outputs near zero: float32
    sums of up to 96 products in another order), the batch statistics rtol 1e-6 atol 1e-6
    (the JAX op's fast variance and the port's two-pass one agree there at
    unit-scale inputs), gradients rtol 3e-4 atol 3e-5. The closed forms are
    also held against torch autograd of the unfused composition in float64
    at rtol 1e-10 (atol 1e-10·max|ref|: sums that cancel to ~0).
(b) The four residual block kinds with ``fused_pointwise=True`` against the
    JAX blocks with ``fused_pointwise=True`` in train mode, dropout off,
    through ``state_dict_from_jax`` (outputs and running statistics at
    tests/test_torch_port_modules.py's bounds); and the port's fused block
    against its unfused block, as test_block_fused_is_dropin holds the JAX
    pair: same state_dict keys, with live dropout (same seed) outputs rtol
    2e-4 atol 2e-5, loss rtol 1e-4, running statistics rtol 3e-4 atol 3e-5,
    gradients rtol 5e-3 atol 5e-4, eval outputs rtol 2e-4 atol 2e-5.
(c) One joint_elbo train step with ``fused_text_head`` and
    ``fused_pointwise`` against the JAX step, at
    tests/test_torch_port_train.py's width and tolerances. The JAX side runs
    two-pass batch variances (that file's ``TwoPassBatchNorm``, and a
    two-pass wrapper of the fused op's Pallas core in interpret mode).
"""

import math
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mopoe_mimic_tpu.models.mmvae as jax_mmvae
from mopoe_mimic_tpu.config import MopoeConfig as JaxConfig
from mopoe_mimic_tpu.models import resblocks as JR
from mopoe_mimic_tpu.models.torch_import import convert_mopoe_state_dict
from mopoe_mimic_tpu.ops import pallas_pointwise as PP
from mopoe_mimic_tpu.train.step import _forward_and_objective as jax_forward_and_objective
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models import resblocks as TR
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.ops import cuda_pointwise
from mopoe_mimic_tpu_torch.ops import pointwise as PW
from mopoe_mimic_tpu_torch.ops.cuda_pointwise import pointwise_cuda, reduce_chunks
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import make_eval_step, make_train_step
from test_torch_port_modules import BLOCKS, assert_close, assert_stats_close, run_pair
from test_torch_port_train import (
    KW,
    TwoPassBatchNorm,
    loss_terms,
    no_dropout,
    numpy_batch,
    port_batch,
)

ROOT = Path(__file__).resolve().parent.parent
EPS = 1e-5
OP_SHAPES = [((6, 5, 5, 64), False), ((30, 48), True), ((4, 7, 96), True)]


def op_case(shape, bias, seed=0):
    """test_pallas_pointwise.py's inputs, as numpy in the JAX layout
    (channels last): x, gamma, beta, W [C, C], cb or None."""
    C = shape[-1]
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return (f(rng.normal(size=shape)), f(rng.normal(size=C) * 0.2 + 1.0),
            f(rng.normal(size=C) * 0.1), f(rng.normal(size=(C, C)) * 0.1),
            f(rng.normal(size=C) * 0.1) if bias else None)


def to_port(x: np.ndarray) -> torch.Tensor:
    """JAX [B, *spatial, C] → the port's [B, C, *spatial]."""
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def to_jax(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# (a) the op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bias", OP_SHAPES)
def test_op_matches_jax_value_stats_and_grads(shape, bias):
    x, g, b, w, cb = op_case(shape, bias)

    def loss_j(x, g, b, w, cb):
        y, m, v = PP.fused_bn_relu_pointwise(x, g, b, w, cb, EPS, interpret=True)
        return jnp.sum(jnp.sin(y)), (y, m, v)

    argnums = (0, 1, 2, 3) if cb is None else (0, 1, 2, 3, 4)
    (_, (y_j, m_j, v_j)), g_j = jax.value_and_grad(loss_j, argnums=argnums, has_aux=True)(
        x, g, b, w, cb)

    leaves = [to_port(x)] + [torch.from_numpy(a) for a in (g, b, w, cb) if a is not None]
    leaves = [t.requires_grad_() for t in leaves]
    y, m, v = PW.fused_bn_relu_pointwise(leaves[0], leaves[1], leaves[2], leaves[3],
                                         leaves[4] if bias else None, EPS, torch.float32)
    torch.sin(y).sum().backward()
    assert y.dtype == torch.float32 and not m.requires_grad and not v.requires_grad
    np.testing.assert_allclose(to_jax(y), y_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), m_j, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), v_j, rtol=1e-6, atol=1e-6)
    got = [to_jax(leaves[0].grad)] + [t.grad.numpy() for t in leaves[1:]]
    for a, r in zip(got, g_j):
        np.testing.assert_allclose(a, r, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("shape,bias", OP_SHAPES)
def test_plain_passes_match_pallas_kernels(shape, bias):
    """pointwise_fwd_plain, pointwise_bwd_reduce_plain and
    pointwise_bwd_dx_plain against the Pallas core and its VJP (the three
    kernels in interpret mode) on the same statistics and cotangent."""
    x, g, b, w, cb = op_case(shape, bias, seed=1)
    C = shape[-1]
    cb = np.zeros(C, np.float32) if cb is None else cb
    x2 = x.reshape(-1, C)
    mean, var = x2.mean(0), x2.var(0)
    dy2 = np.random.default_rng(2).normal(size=x2.shape).astype(np.float32)

    def core(x2, g, b, w, cb):
        return PP._core(x2, g, b, mean, var, w, cb, EPS, True)

    y_j, vjp = jax.vjp(core, x2, g, b, w, cb)
    dx_j, dg_j, db_j, dw_j, dcb_j = vjp(dy2)

    x3 = to_port(x).reshape(shape[0], C, -1)
    dy3 = to_port(dy2.reshape(shape)).reshape(shape[0], C, -1)
    t = [torch.from_numpy(a) for a in (g, b, mean)] + [PW.inv_std(torch.from_numpy(var), EPS)]
    wt, cbt = torch.from_numpy(w), torch.from_numpy(cb)
    y = PW.pointwise_fwd_plain(x3, *t, wt, cbt)
    dw, dcb, dg, db = PW.pointwise_bwd_reduce_plain(x3, *t, wt, dy3)
    dx = PW.pointwise_bwd_dx_plain(x3, *t, wt, dy3, dg, db)
    rows = lambda a: to_jax(a.reshape(shape[0], C, *shape[1:-1])).reshape(-1, C)  # noqa: E731
    np.testing.assert_allclose(rows(y), y_j, rtol=1e-5, atol=1e-6)
    for got, ref in ((rows(dx), dx_j), (dg, dg_j), (db, db_j), (dw, dw_j), (dcb, dcb_j)):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("spatial", [(5, 3), (7,)])
def test_plain_closed_forms_match_autograd_float64(spatial, transpose):
    """The plain forward and passes A and B, in float64, against torch
    autograd of F.batch_norm (train) → relu → the block's 1×1 conv or
    transposed conv, with W taken from the conv weight as the block takes
    it (a wrong transpose fails here: the weights are not symmetric)."""
    rng = np.random.default_rng(3)
    B, C, Co = 4, 6, 5
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    ones = (1,) * len(spatial)
    x = t(rng.normal(size=(B, C) + spatial) * 1.5 + 0.3)
    g, b = t(rng.normal(size=C) * 0.2 + 1.0), t(rng.normal(size=C) * 0.1)
    k = t(rng.normal(size=((C, Co) if transpose else (Co, C)) + ones) * 0.3)
    cb = t(rng.normal(size=Co) * 0.1)
    dy = t(rng.normal(size=(B, Co) + spatial))
    leaves = [a.clone().requires_grad_() for a in (x, g, b, k, cb)]
    hn = torch.relu(torch.nn.functional.batch_norm(
        leaves[0], None, None, leaves[1], leaves[2], training=True, eps=EPS))
    F = torch.nn.functional
    conv = {(False, 1): F.conv1d, (False, 2): F.conv2d,
            (True, 1): F.conv_transpose1d, (True, 2): F.conv_transpose2d}[transpose, len(spatial)]
    ref_y = conv(hn, leaves[3], leaves[4])
    ref = torch.autograd.grad(ref_y, leaves, dy)

    w = PW.conv1x1_matrix(k, transpose)
    x3, dy3 = x.reshape(B, C, -1), dy.reshape(B, Co, -1)
    mean, var = PW.batch_stats(x3)
    inv = PW.inv_std(var, EPS)
    y = PW.pointwise_fwd_plain(x3, g, b, mean, inv, w, cb)
    dw, dcb, dg, db = PW.pointwise_bwd_reduce_plain(x3, g, b, mean, inv, w, dy3)
    dx = PW.pointwise_bwd_dx_plain(x3, g, b, mean, inv, w, dy3, dg, db)
    dk = (dw if transpose else dw.t()).reshape(k.shape)
    for got, want in ((y.reshape(ref_y.shape), ref_y), (dx.reshape(x.shape), ref[0]),
                      (dg, ref[1]), (db, ref[2]), (dk, ref[3]), (dcb, ref[4])):
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, want.detach(), rtol=1e-10,
                                   atol=1e-10 * float(want.detach().abs().max()))


def test_batch_stats_two_pass_and_dtypes():
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 5, 4, 2)) + 1e3)
    for dtype, want in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                        (torch.float64, torch.float64)):
        m, v = PW.batch_stats(x.to(dtype))
        assert m.dtype == v.dtype == want and m.shape == v.shape == (5,)
    m, v = PW.batch_stats(x)
    ref_v, ref_m = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(m, ref_m, rtol=1e-12, atol=0)
    torch.testing.assert_close(v, ref_v, rtol=1e-10, atol=0)


def test_bf16_compute_rounds_h_and_y_like_the_kernels():
    """Compute dtype bfloat16 on the CPU: h rounded to bfloat16 and the
    product summed in float32 (not a bfloat16 CPU matmul), y in bfloat16;
    gradients: dx in x's dtype, dW rounded to bfloat16 (then cast back to
    the float32 parameter, as autocast's cast does), dγ, dβ, dcb float32."""
    x, g, b, w, cb = op_case((4, 6, 32), True, seed=5)
    leaves = [to_port(x).requires_grad_()] + [torch.from_numpy(a).requires_grad_()
                                              for a in (g, b, w, cb)]
    y, mean, var = PW.fused_bn_relu_pointwise(*leaves, EPS, torch.bfloat16)
    assert y.dtype == torch.bfloat16
    x3 = leaves[0].detach().reshape(4, 32, 6)
    _, h = PW._norm(x3, leaves[1].detach(), leaves[2].detach(), mean, PW.inv_std(var, EPS))
    wt = torch.from_numpy(w).to(torch.bfloat16).double().t()
    want = (wt @ h.to(torch.bfloat16).double() + torch.from_numpy(cb).double()[:, None])
    # float32 sums against float64 ones: equal up to one bf16 rounding step
    torch.testing.assert_close(y.reshape(4, 32, 6).float(), want.to(torch.bfloat16).float(),
                               rtol=2.0 ** -8, atol=0)
    (y.float() * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    assert all(t.grad.dtype == torch.float32 for t in leaves)
    assert torch.equal(leaves[3].grad, leaves[3].grad.to(torch.bfloat16).float())


def test_cuda_wrapper_refuses_cpu_tensors():
    x, g, b, w, cb = (torch.from_numpy(a) for a in op_case((2, 3, 8), True))
    x3 = x.permute(0, 2, 1).contiguous()
    with pytest.raises(ValueError, match="not a CUDA device"):
        pointwise_cuda(x3, g, b, g, g, w, cb)
    with pytest.raises(ValueError, match="not a CUDA device"):
        cuda_pointwise.pointwise_stats_cuda(x3, EPS, (g.clone(), g.clone(), 0.1))


@pytest.mark.parametrize("shape,bias", OP_SHAPES)
def test_plain_batch_stats_match_jax_reference(shape, bias):
    """The fused op's plain statistics (``batch_stats``: two passes) against
    the JAX op's (``reference_bn_relu_pointwise``: the fast variance E[x²]
    − μ², whose float32 cancellation is ~1e-7·E[x²]): at these unit-scale
    inputs mean rtol 1e-6 atol 1e-6, variance rtol 1e-5 atol 1e-6."""
    x, g, b, w, cb = op_case(shape, bias, seed=6)
    _, m_j, v_j = PP.reference_bn_relu_pointwise(x, g, b, w, cb, EPS)
    _, m, v = PW.fused_bn_relu_pointwise(to_port(x), *(torch.from_numpy(a) for a in (g, b, w)),
                                         None if cb is None else torch.from_numpy(cb), EPS,
                                         torch.float32)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spatial", [(6, 5), (11,)])
def test_fused_op_statistics_match_torch_batchnorm(spatial, dtype):
    """The fused op's statistics on the CPU (the plain path, the kernel's
    oracle) against ``nn.BatchNorm{2,1}d`` in train mode on the same x, cast
    up to float32 as the unfused block does: the batch mean and biased
    variance against a BatchNorm at momentum 1 (its running mean is the
    batch mean, its running variance the unbiased one), and the running
    buffers through two steps at momentum 0.1 from seeded buffers. rtol
    1e-5, atol 1e-6: float32 sums in another order."""
    rng = np.random.default_rng(7)
    B, C = 4, 7
    bn_cls = torch.nn.BatchNorm2d if len(spatial) == 2 else torch.nn.BatchNorm1d
    ref = bn_cls(C, momentum=0.1)
    with torch.no_grad():
        ref.running_mean.copy_(torch.from_numpy(rng.normal(size=C) * 0.1))
        ref.running_var.copy_(torch.from_numpy(0.5 + rng.random(C)))
    running = (ref.running_mean.clone(), ref.running_var.clone(), 0.1)
    g, b = torch.ones(C), torch.zeros(C)
    w = torch.from_numpy(rng.normal(size=(C, 3)).astype(np.float32))
    n = B * math.prod(spatial)
    close = dict(rtol=1e-5, atol=1e-6)
    for _ in range(2):
        x = torch.from_numpy((rng.normal(size=(B, C, *spatial)) * 1.5 + 0.3).astype(np.float32))
        x = x.to(dtype)
        once = bn_cls(C, momentum=1.0)
        ref(x.float())
        once(x.float())
        _, mean, var = PW.fused_bn_relu_pointwise(x, g, b, w, None, EPS, torch.float32, running)
        assert mean.dtype == var.dtype == torch.float32
        torch.testing.assert_close(mean, once.running_mean, **close)
        torch.testing.assert_close(var * (n / (n - 1)), once.running_var, **close)
        torch.testing.assert_close(running[0], ref.running_mean, **close)
        torch.testing.assert_close(running[1], ref.running_var, **close)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_fused_op_running_update_equals_the_blocks_former_update(dtype):
    """On the CPU the fused op's ``running`` argument updates the buffers
    exactly as the block's separate update did before it (``nn.BatchNorm``'s
    formula on the op's statistics, written out here), and a fused block in
    train mode counts its batch once."""
    x, g, b, w, _ = op_case((5, 3, 4, 6), False, seed=8)
    x, g, b, w = to_port(x).to(dtype), *(torch.from_numpy(a) for a in (g, b, w))
    buf = torch.float64 if dtype == torch.float64 else torch.float32
    start = (torch.linspace(-0.2, 0.3, 6, dtype=buf), torch.linspace(0.5, 2.0, 6, dtype=buf))
    running = (start[0].clone(), start[1].clone(), 0.1)
    compute = torch.float64 if dtype == torch.float64 else torch.float32
    args = (g.to(compute), b.to(compute), w.to(compute))
    _, mean, var = PW.fused_bn_relu_pointwise(x, *args, None, EPS, compute, running)
    n, m = 5 * 3 * 4, 0.1
    want_mean = start[0].clone().mul_(1.0 - m).add_(mean.to(buf), alpha=m)
    want_var = start[1].clone().mul_(1.0 - m).add_((var * (n / (n - 1))).to(buf), alpha=m)
    assert torch.equal(running[0], want_mean) and torch.equal(running[1], want_var)

    block = TR.ResidualBlock2dConv(6, 4, fused_pointwise=True).to(compute)
    before = block.bn1.num_batches_tracked.clone()
    block.train()(x.to(compute))
    assert int(block.bn1.num_batches_tracked) == int(before) + 1


# (B, C, S) of the flagship's 32 blocks, and odd ones
FLAGSHIP_BLOCKS = [(256, 64, 4096), (256, 128, 1024), (256, 192, 256), (256, 256, 64),
                   (256, 320, 16), (256, 64, 64), (256, 128, 32), (256, 192, 16), (256, 256, 8),
                   (256, 256, 4), (256, 256, 2), (256, 320, 1), (256, 256, 16), (256, 192, 64),
                   (256, 128, 256), (256, 64, 1024), (256, 320, 4), (256, 320, 8),
                   (256, 256, 32)]
ODD_BLOCKS = [(7, 3, 1), (5, 3, 33), (2, 48, 7), (3, 64, 25), (1, 2048, 1), (9, 130, 5)]


def _chunkings(R, C, Co):
    yield reduce_chunks(R, C, Co)
    for x_bytes in (2, 4):
        yield cuda_pointwise.reduce_tc_chunks(R, C, Co, x_bytes)


@pytest.mark.parametrize("R,C,Co", [(1_048_576, 64, 64), (256, 320, 320), (4096, 320, 320),
                                    (16384, 256, 256), (7, 3, 5)]
                         + [(B * S, C, C) for B, C, S in FLAGSHIP_BLOCKS + ODD_BLOCKS])
def test_reduce_chunks_cover_the_rows(R, C, Co):
    """Both passes A's chunkings (float32 and bfloat16) cover every row
    exactly once, in chunks of whole 64-row tiles."""
    for rows, chunks in _chunkings(R, C, Co):
        assert rows % 64 == 0 and rows >= 64
        assert (chunks - 1) * rows < R <= chunks * rows
        starts = range(0, chunks * rows, rows)
        covered = [n for start in starts for n in range(start, min(R, start + rows))]
        assert covered == list(range(R))


def _persistent_tiles(tiles: int, grid_x: int):
    """The row tiles that the blocks of pointwise_bwd_dx_tc's persistent
    grid take (csrc: block bx takes tiles bx, bx + grid_x, ..., my_tiles of
    them), in the order the blocks take them."""
    for bx in range(grid_x):
        mine = (tiles - 1 - bx) // grid_x + 1 if tiles > bx else 0
        yield from (bx + t * grid_x for t in range(mine))


@pytest.mark.parametrize("B,C,S", FLAGSHIP_BLOCKS + ODD_BLOCKS)
def test_dx_tc_and_stats_tilings_cover_the_rows(B, C, S):
    """bfloat16 pass B's row tiles (``dx_tc_rows``, the persistent grid at
    any width) take every row exactly once, 64-row tiles where they fill a
    wave and smaller ones where those fill it better; the statistics'
    chunks (``stats_chunks``) take every b exactly once, with the partials'
    traffic below the bytes of x."""
    R, c_tiles = B * S, math.ceil(C / 64)
    rows = cuda_pointwise.dx_tc_rows(R, C)
    tiles = math.ceil(R / rows)
    wave = cuda_pointwise.WAVE_BLOCKS
    assert rows in (16, 32, 64)
    assert (rows == 64) == (math.ceil(R / 64) * c_tiles >= wave)
    if math.ceil(R / 16) * c_tiles >= wave:
        assert tiles * c_tiles >= wave
    for grid_x in sorted({1, 7, max(1, min(tiles, wave // c_tiles)), tiles}):
        assert sorted(_persistent_tiles(tiles, grid_x)) == list(range(tiles))
    assert (tiles - 1) * rows < R <= tiles * rows
    for x_bytes in (2, 4):
        per, chunks = cuda_pointwise.stats_chunks(B, C, S, x_bytes)
        covered = [b for k in range(chunks) for b in range(k * per, min(B, (k + 1) * per))]
        assert covered == list(range(B)) and (chunks - 1) * per < B
        assert chunks == 1 or 16 * chunks < B * S * x_bytes
        lanes = cuda_pointwise.stats_lanes(S, x_bytes)
        assert lanes in (1, 2, 4, 8, 16, 32)


@pytest.mark.parametrize("B,C,S", FLAGSHIP_BLOCKS)
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_tc_pass_a_scratch_stays_below_its_inputs(B, C, S, x_bytes):
    """bfloat16 pass A at every flagship block: at most one wave of blocks,
    and its partials' traffic below the bytes it must read."""
    R = B * S
    rows, chunks = cuda_pointwise.reduce_tc_chunks(R, C, C, x_bytes)
    assert chunks * math.ceil(C / 64) ** 2 <= cuda_pointwise.WAVE_BLOCKS
    assert (cuda_pointwise.pass_a_scratch_bytes(R, C, C, chunks)
            < cuda_pointwise.pass_a_input_bytes(R, C, C, x_bytes))


# ---------------------------------------------------------------------------
# (b) the residual blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_fused_block_train_mode_matches_jax(kind, no_jax_dropout):
    j_cls, t_cls, spatial, kw, top, group, strip = BLOCKS[kind]
    cin, cout = 3, 5
    x = np.random.default_rng(21).normal(size=(4,) + (8,) * spatial + (cin,)).astype(np.float32)
    got, ref, stats, ref_stats = run_pair(
        j_cls(features=cout, kernel_size=4, stride=2, padding=1, fused_pointwise=True, **kw),
        t_cls(cin, cout, 4, 2, 1, fused_pointwise=True),
        jnp.asarray(x), to_port(x), top, group, strip, seed=22, train=True)
    assert_close(to_jax(got), ref)
    assert_stats_close(stats, ref_stats)


@pytest.fixture
def no_jax_dropout(monkeypatch):
    monkeypatch.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)


DROPIN = {
    # name: (port class, input shape, out channels, extra kwargs)
    "2d_conv": (TR.ResidualBlock2dConv, (8, 64, 16, 16), 128, {}),
    "2d_transpose": (TR.ResidualBlock2dTransposeConv, (4, 32, 6, 6), 16, {}),
    "1d_conv": (TR.ResidualBlock1dConv, (8, 48, 12), 64, {}),
    "1d_transpose": (TR.ResidualBlock1dTransposeConv, (8, 64, 12), 32, {"output_padding": 1}),
}


@pytest.mark.parametrize("kind", sorted(DROPIN))
def test_fused_block_is_dropin_for_unfused(kind):
    cls, shape, cout, kw = DROPIN[kind]
    torch.manual_seed(0)
    unfused = cls(shape[1], cout, **kw)
    fused = cls(shape[1], cout, fused_pointwise=True, **kw)
    assert unfused.state_dict().keys() == fused.state_dict().keys()
    fused.load_state_dict(unfused.state_dict())
    x = torch.from_numpy(np.random.default_rng(23).normal(size=shape).astype(np.float32))

    def run(mod):
        mod.train()
        torch.manual_seed(7)  # the same dropout masks on both sides
        y = mod(x)
        loss = torch.tanh(y).sum()
        grads = torch.autograd.grad(loss, list(mod.parameters()))
        return float(loss.detach()), y.detach(), grads

    lu, yu, gu = run(unfused)
    lf, yf, gf = run(fused)
    torch.testing.assert_close(yf, yu, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lf, lu, rtol=1e-4)
    su, sf = unfused.state_dict(), fused.state_dict()
    for k in su:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sf[k], su[k], rtol=3e-4, atol=3e-5)
        assert torch.equal(sf["bn1.num_batches_tracked"], su["bn1.num_batches_tracked"])
    for a, r in zip(gf, gu):
        torch.testing.assert_close(a, r, rtol=5e-3, atol=5e-4)
    unfused.eval()
    fused.eval()
    with torch.no_grad():
        torch.testing.assert_close(fused(x), unfused(x), rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# (c) one train step
# ---------------------------------------------------------------------------

CASE = dict(method="joint_elbo", fused_text_head=True, fused_pointwise=True)


def two_pass_fused_bn_relu_pointwise(x, gamma, beta, kernel, cbias, eps,
                                     compute_dtype=jnp.float32, interpret=False):
    """The JAX op with the batch variance in two passes, E[(x − μ)²], on the
    Pallas core in interpret mode: the JAX side of the comparison."""
    lead, C = x.shape[:-1], x.shape[-1]
    kernel = kernel.reshape(C, -1)
    x2 = x.reshape(-1, C)
    xf = x2.astype(jnp.float32)
    mean = jnp.mean(xf, axis=0)
    var = jnp.mean(jnp.square(xf - mean), axis=0)
    cb = (jnp.zeros((kernel.shape[1],), jnp.float32) if cbias is None
          else cbias.astype(jnp.float32))
    y = PP._core(x2, gamma.astype(jnp.float32), beta.astype(jnp.float32),
                 jax.lax.stop_gradient(mean), jax.lax.stop_gradient(var),
                 kernel.astype(compute_dtype), cb, eps, True)
    return y.reshape(*lead, kernel.shape[1]), mean, var


@pytest.fixture(scope="module")
def fused_step():
    """(JAX: loss terms, gradients, updated running statistics as the port's
    state_dict entries; port: the same and the step's metrics) of one step
    from the port's seeded init, dropout off, z = mu."""
    cfg = MopoeConfig(**KW, **CASE)
    sd = create_train_state(cfg, device="cpu", seed=11).model.state_dict()
    batch = numpy_batch(seed=11)

    jcfg = JaxConfig(**KW, **CASE)
    conv = convert_mopoe_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)
    params, bstats = conv["params"], conv["batch_stats"]
    model = jax_mmvae.MMVae(jcfg)
    rngs = {"dropout": jax.random.PRNGKey(0), "reparam": jax.random.PRNGKey(1)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JR._BlockBase, "_dropout", lambda self, x, det, r: x)
        mp.setattr(JR, "TorchBatchNorm", TwoPassBatchNorm)
        mp.setattr(JR, "fused_bn_relu_pointwise", two_pass_fused_bn_relu_pointwise)
        mp.setattr(jax_mmvae, "reparameterize", lambda rng, mu, lv: mu)

        def loss_fn(p):
            total, new_bs, metrics = jax_forward_and_objective(jcfg, model, p, bstats, jbatch,
                                                               rngs, train=True)
            return total, (new_bs, metrics)

        (_, (new_bs, metrics)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params)
    j_terms = loss_terms(jax.device_get(metrics))
    j_grads = state_dict_from_jax({"params": jax.device_get(grads)}, cfg)
    j_stats = {k: v for k, v in state_dict_from_jax(
        {"params": params, "batch_stats": jax.device_get(new_bs)}, cfg).items()
        if k.endswith(("running_mean", "running_var"))}

    state = create_train_state(cfg, device="cpu", state_dict=sd)
    no_dropout(state.model)
    m = make_train_step(cfg, eps=0.0)(state, port_batch(batch))
    p_grads = {k: p.grad.clone() for k, p in state.model.named_parameters()}
    p_stats = {k: v.clone() for k, v in state.model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))}
    return (j_terms, j_grads, j_stats), (loss_terms(m), p_grads, p_stats, m)


def test_fused_step_loss_terms_match_jax(fused_step):
    (j_terms, _, _), (p_terms, _, _, _) = fused_step
    assert j_terms.keys() == p_terms.keys()
    for k, ref in j_terms.items():
        assert np.isfinite(ref), k
        np.testing.assert_allclose(p_terms[k], ref, rtol=1e-4, err_msg=k)


def test_fused_step_gradients_match_jax(fused_step):
    """test_torch_port_train.test_gradients_match_jax's bounds."""
    (_, j_grads, _), (_, p_grads, _, m) = fused_step
    assert j_grads.keys() == p_grads.keys()
    g_max = max(float(g.abs().max()) for g in j_grads.values())
    tiny = 0
    for k, ref in j_grads.items():
        ref, got = ref.numpy(), p_grads[k].numpy()
        if max(np.abs(ref).max(), np.abs(got).max()) <= 1e-5 * g_max:
            tiny += 1
            continue
        atol = 1e-4 * float(np.abs(ref).max()) + 1e-7 * g_max
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=k)
    assert tiny < 0.2 * len(j_grads), tiny
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in j_grads.values()))
    np.testing.assert_allclose(float(m["grad_norm"]), norm, rtol=1e-4)


def test_fused_step_running_stats_match_jax(fused_step):
    (_, _, j_stats), (_, _, p_stats, _) = fused_step
    assert j_stats.keys() == p_stats.keys() and j_stats
    for k in j_stats:
        assert_close(p_stats[k].numpy(), j_stats[k].numpy())


def test_fused_model_runs_every_block_through_the_op(monkeypatch):
    """Under fused_pointwise a train step calls the fused op once per
    residual block (28 at 64 px; the 128 px flagship has 32, which
    chip_smoke.py counts as kernel launches per step); the eval step runs
    the modules and never calls it."""
    calls = []
    apply = PW._PlainPointwise.apply
    monkeypatch.setattr(PW._PlainPointwise, "apply",
                        lambda *args: calls.append(args[0].shape) or apply(*args))
    cfg = MopoeConfig(**KW, **CASE)
    state = create_train_state(cfg, device="cpu", seed=12)
    blocks = [m for m in state.model.modules() if isinstance(m, TR._ResidualBlock)]
    assert len(blocks) == 28 and all(b.fused_pointwise for b in blocks)
    make_train_step(cfg, eps=0.0)(state, port_batch(numpy_batch(seed=12)))
    assert len(calls) == 28
    make_eval_step(cfg, eps=0.0)(state, port_batch(numpy_batch(seed=13)))
    assert len(calls) == 28
    flagship = MopoeConfig.from_json(str(ROOT / "configs" / "flagship.json"),
                                     fused_pointwise=True)
    with torch.device("meta"):
        model = MMVae(flagship)
    assert sum(isinstance(m, TR._ResidualBlock) for m in model.modules()) == 32


def test_chip_smoke_profile_takes_each_kernel_from_a_session_that_recorded_it(monkeypatch):
    """chip_smoke.py's ``device_us_by_kernel`` against sessions of a stand-in
    profiler that drop all of a session's events, or some launches: each
    kernel's time comes from the first session that recorded all its
    launches, sessions are retaken until every expected kernel has one, and
    a kernel that no session recorded is left out."""
    import types

    import chip_smoke
    from torch.autograd import DeviceType

    def event(name, us):
        return types.SimpleNamespace(device_type=DeviceType.CUDA, name=f"void {name}<1>(int)",
                                     time_range=types.SimpleNamespace(start=0.0, end=us))

    def session(records):
        class Session:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return [event(n, us) for n, us in records]
        return Session()

    def profiler(sessions):
        it = iter(sessions)
        monkeypatch.setattr(torch.profiler, "profile", lambda **kw: session(next(it)))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    a5, b5 = [("a", 2.0)] * 5, [("b", 4.0)] * 10
    profiler([[], [("a", 3.0)] * 3, a5, b5])  # empty; a partly; a whole; b whole
    assert chip_smoke.device_us_by_kernel(lambda: None, expect=("a", "b")) == {"a": 2.0,
                                                                                "b": 8.0}
    profiler([[("a", 3.0)] * 3] * 6)  # 3 of 5 launches: the mean a launch, once a call
    assert chip_smoke.device_us_by_kernel(lambda: None, expect=("a",)) == {"a": 3.0}
    profiler([[]] * 6)
    assert chip_smoke.device_us_by_kernel(lambda: None, expect=("a",)) == {}
    profiler([[], a5 + b5])  # without expect, the first session that recorded anything
    assert chip_smoke.device_us_by_kernel(lambda: None) == {"a": 2.0, "b": 8.0}


def test_chip_smoke_k3_phase_and_fused_training_rehearse_on_cpu(monkeypatch):
    """chip_smoke.py's K3 phase (checks, timings, bounds, the cuDNN
    comparison, the statistics' checks and timings) with the plain versions
    standing in for the kernels, at small shapes, and its fused_pointwise
    training run on the CPU, where no kernel launches."""
    import chip_smoke

    cp = chip_smoke.cuda_pointwise

    def partials(*args):  # one chunk (and one output tile)
        dw, dcb, dg, db = PW.pointwise_bwd_reduce_plain(*args)
        return dw[None], dcb[None], dg[None, None], db[None, None]

    def finalize(dw, dcb, dg, db):
        return dw.sum(0), dcb.sum(0), dg.sum((0, 1)), db.sum((0, 1))

    def stats_partials(x3):  # each chunk's mean and M2, two passes
        B, C, S = x3.shape
        chunks = x3.float().split(cp.stats_chunks(B, C, S, x3.element_size())[0])
        means = [c.mean((0, 2)) for c in chunks]
        return torch.stack([torch.stack(means), torch.stack(
            [(c - m[:, None]).square().sum((0, 2)) for c, m in zip(chunks, means)])])

    def stats_finalize(part, B, S, per, eps, running=None):
        counts = torch.tensor([(min(B, (k + 1) * per) - k * per) * S
                               for k in range(part.shape[1])], dtype=torch.float32)
        mean, var, inv = chip_smoke.stats_finalize_plain(part, counts, eps)
        if running is not None:
            PW.update_running_stats(*running, mean, var, B * S)
        return mean, var, inv

    monkeypatch.setattr(cp, "pointwise_fwd_cuda",
                        lambda *a: PW.pointwise_fwd_plain(*a).to(a[5].dtype))
    monkeypatch.setattr(cp, "pointwise_bwd_partials_cuda", partials)
    monkeypatch.setattr(cp, "pointwise_bwd_finalize_cuda", finalize)
    monkeypatch.setattr(cp, "pointwise_bwd_reduce_cuda", lambda *a: finalize(*partials(*a)))
    monkeypatch.setattr(cp, "pointwise_bwd_dx_cuda",
                        lambda *a: PW.pointwise_bwd_dx_plain(*a).to(a[0].dtype))
    monkeypatch.setattr(cp, "pointwise_stats_cuda", chip_smoke.plain_stats)
    monkeypatch.setattr(cp, "pointwise_stats_partials_cuda", stats_partials)
    monkeypatch.setattr(cp, "pointwise_stats_finalize_cuda", stats_finalize)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, calls=1, warmup=0: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "K3_CASES", ((3, 64, 64, (5, 5), True, True),
                                                 (4, 32, 32, (8, 8), False, True),
                                                 (4, 80, 80, (1,), True, False),
                                                 (4, 80, 80, (2, 2), False, False)))
    with warnings.catch_warnings():  # autocast("cuda") warns that it is off without a card
        warnings.simplefilter("ignore", UserWarning)
        out = chip_smoke.k3_against_plain(torch.device("cpu"))
        stats = chip_smoke.k3_stats_against_plain(torch.device("cpu"), "card")
    keys = {"max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert set(stats) == {"pointwise_stats", "pointwise_stats_finalize"}
    assert set(out) | set(stats) == set(chip_smoke.K3)
    assert all(keys <= set(v) for v in (*out.values(), *stats.values()))
    # the statistics read x (4, 32, 64) bf16 once and write mean, var and inv
    # and the two running buffers (read too) of 32 channels
    assert stats["pointwise_stats"]["bound_ms"] == pytest.approx(
        (4 * 32 * 64 * 2 + 7 * 32 * 4) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert stats["pointwise_stats"]["library_ms"] == 1.0
    assert stats["pointwise_stats_finalize"]["library_ms"] is None
    x3 = torch.randn(5, 6, 7) * 3 + 1
    part = stats_partials(x3)  # the plain finalize merges per-chunk states exactly
    per = cp.stats_chunks(5, 6, 7, 4)[0]
    assert part.shape[1] > 1
    mean, var, _ = stats_finalize(part, 5, 7, per, EPS)
    ref_mean, ref_var = PW.batch_stats(x3)
    torch.testing.assert_close(mean, ref_mean, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, ref_var, rtol=1e-5, atol=1e-6)
    assert out["pointwise_fwd_tc"]["block_ms"].keys() == {"fused_fwd", "fused_fwd_bwd",
                                                          "unfused_fwd", "unfused_fwd_bwd"}
    # bf16 pass A's bound at (4, 32, 32, 8×8), x bf16: x, dy and W read
    # once, the statistics read once, dW, dcb, dγ, dβ written once; no partials
    moved = 2 * (4 * 32 * 64 * 2) + 32 * 32 * 2 + 4 * 32 * 4 + (32 * 32 + 3 * 32) * 4
    assert out["pointwise_bwd_reduce_tc"]["bound_ms"] == pytest.approx(
        moved / chip_smoke.HBM_BYTES_PER_S * 1e3)
    tc = out["pointwise_bwd_reduce_tc"]
    assert tc["partials_ms"] == 1.0 and 0 < tc["scratch_bytes"] < tc["input_bytes"]
    # the float32 CUDA-core forward and pass A, timed at the same block in float32
    assert out["pointwise_bwd_reduce"]["partials_ms"] == 1.0
    assert out["pointwise_fwd"]["bound_ms"] > out["pointwise_fwd_tc"]["bound_ms"]

    # phase 7's per-block-shape profile, the profiler's figures stood in for
    names = ("pointwise_stats_kernel", "pointwise_stats_finalize_kernel", "pointwise_fwd_tc",
             "pointwise_bwd_reduce_tc", "pointwise_bwd_finalize_kernel", "pointwise_bwd_dx_tc")
    monkeypatch.setattr(chip_smoke, "device_us_by_kernel",
                        lambda fn, calls=5, expect=(): (fn(), dict.fromkeys(names, 2.0))[1])
    shapes = {(4, 32, 8, 32, torch.bfloat16): 2, (3, 64, 1, 64, torch.float32): 1}
    assert chip_smoke.k3_block_profile(shapes, torch.device("cpu"), "card") == {
        "pointwise_stats": 6.0, "pointwise_stats_finalize": 6.0, "pointwise_fwd_tc": 6.0,
        "pointwise_bwd_reduce_tc": 6.0, "pointwise_bwd_finalize": 6.0,
        "pointwise_bwd_dx_tc": 6.0, "plain_stats": 36.0}
    # where no profiler session recorded a kernel, CUDA events time it (1 ms here)
    monkeypatch.setattr(chip_smoke, "device_us_by_kernel",
                        lambda fn, calls=5, expect=(): (fn(), {})[1])
    assert chip_smoke.k3_block_profile(shapes, torch.device("cpu"), "card") == dict.fromkeys(
        ("pointwise_stats", "pointwise_stats_finalize", "pointwise_fwd_tc",
         "pointwise_bwd_reduce_tc", "pointwise_bwd_finalize", "pointwise_bwd_dx_tc",
         "plain_stats"), 3000.0)

    cfg = MopoeConfig(**KW, **CASE, lr_warmup_steps=300)
    run = chip_smoke.drive_training(cfg, "cpu", kernels=(), per_step={}, warmup=1, steps=1)
    assert run["p50_ms"] > 0 and not any(run["launches"].values())
    turns = chip_smoke.steps_in_turns({"a": run, "b": run}, steps=1)
    assert set(turns) == {"a", "b"}
