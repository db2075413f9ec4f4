"""The port's train-mode BatchNorm (``ops/batchnorm.py``, the kernels of
``csrc/batchnorm.cu`` behind ``ops/cuda_batchnorm.py``) and its routing in
``models/resblocks.py``.

CPU cases (one intra-op thread, no JAX): CPU tensors, float32 BatchNorms
and eval mode go to the module unchanged; the op's plain version equals
``nn.BatchNorm{1,2}d`` in train mode bit for bit (output, running
statistics, ``num_batches_tracked``, gradients); the wrapper raises on
what the kernels do not take; the plans of the kernels' grid, [N, C, S]
and channels-innermost; which layout the op reads in place and what it
copies; the channels-last 2-D networks (a train step of the resnet encoder
and decoder and of the DenseNet encoder at 64 px: every 4-D activation,
conv weight, conv gradient, BatchNorm output gradient and Adam state
channels-last, the outputs and the step those of the NCHW modules within
float32 rounding) and the networks that stay NCHW.

Card cases (marked ``cuda``, skipped without a CUDA device; this file
imports neither jax nor the JAX package, so on a machine without them
run ``python -m pytest --noconftest -m cuda tests/test_torch_port_batchnorm.py``):
the kernels against ATen's bf16 BatchNorm (``native_batch_norm`` and its
backward, what ``nn.BatchNorm`` runs for a bf16 input with float32
weights) at every main-path shape of the word, char and DenseNet-121
(``train.densenet256``) configurations, on both plans: x [N, C, S] and the
same values channels-last ([N·S, C]).
Tolerances and their reasons:

* y within 1 bf16 ulp of ATen's, plus 1e-5 of the channel's terms
  (|γ|·max|x − mean|·invstd + |β|): both round once to bf16 a float32
  value whose statistics differ by float32 sums in another order, so a
  rounding can fall on either side; where γ·xhat + β cancels towards 0 the
  ulp of the result shrinks below the float32 difference of its terms.
* The saved mean within 1e-5 relative of ATen's, plus 2e-6·sqrt(var) (a
  mean near 0 is known to its spread's scale; each side's float32 sums
  over up to 2^20 elements in its own order), invstd and the running
  variance within 1e-5 relative, the running mean within 1e-5 relative
  plus the momentum's share of the mean's floor.
* The backward against a float64 reference on the same bf16 inputs, not
  against ATen: ATen's NCHW backward kernel (``batch_norm_backward_kernel``)
  gives dβ only within ~4e-3 of the float64 sum at these shapes (measured
  on an H100: PERF.md, Findings), and its dx up to ~30 bf16 ulps off where
  the kernels' dx rounds the float64 value correctly. dγ and dβ within
  1e-4 relative plus 1e-6 of the sum of the terms' magnitudes
  (Σ|dy·(x − mean)|·invstd, Σ|dy|: a sum that cancels is held relative
  to its terms). dγ sums over x − mean, the mean the forward saved in
  float32: it is held to the float64 sum on the saved mean and invstd, and
  to the one on float64 statistics with |Σdy·δmean|·invstd added to the
  bound, δmean the saved mean's own error. Where a channel's |mean| is
  30-53 times its spread, that term alone exceeded the bound, at δmean of
  4e-8-1.2e-7 of the mean (measured on an H100: PERF.md, Findings). dx within 2 bf16
  ulps plus 1e-5 of the channel's terms (|dy|, |x − mean|·|dot|/n·invstd²,
  |Σdy|/n, times invstd·|γ|), for the same cancellation as y's.
* Two runs, and a CUDA graph's replay against the eager call, bitwise
  equal: every sum has a fixed order, no atomics.
"""

import math
from types import SimpleNamespace

import pytest
import torch
from torch import nn

from mopoe_mimic_tpu_torch.models import resblocks
from mopoe_mimic_tpu_torch.models.resblocks import ResidualBlock1dConv, ResidualBlock2dConv
from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.ops import batchnorm as B
from mopoe_mimic_tpu_torch.ops import cuda_batchnorm
from mopoe_mimic_tpu_torch.ops.batchnorm import batch_norm_train

# (C, S) of every train-mode BatchNorm of a word and a char step at
# batch 256, with its count a step (2-D maps flattened: S = H·W)
WORD = {(64, 4096): 6, (128, 1024): 6, (192, 256): 6, (256, 64): 9, (320, 16): 9, (320, 1): 9,
        (256, 16): 6, (192, 64): 6, (128, 256): 6, (64, 1024): 6, (128, 32): 3, (192, 16): 3,
        (256, 8): 3, (256, 4): 3, (256, 2): 3, (320, 4): 3, (320, 8): 3, (256, 32): 3,
        (64, 64): 2, (64, 128): 1}
CHAR = {(64, 4096): 6, (128, 1024): 6, (192, 256): 6, (256, 64): 12, (320, 16): 9, (320, 1): 9,
        (128, 256): 12, (192, 128): 6, (256, 32): 6, (320, 8): 6, (320, 4): 6, (256, 16): 9,
        (192, 64): 6, (64, 1024): 6, (64, 512): 3}


def densenet_trunk(img: int) -> dict:
    """(C, S) of one DenseNet-121 trunk's BatchNorms at ``img`` px, with
    their counts: norm0 after the 7×7/2 stem, each dense layer's norm1 (its
    block's concatenation, 32 channels more a layer) and norm2 (the 128-wide
    bottleneck), each transition's norm before it halves the channels and
    the side, norm5."""
    out: dict = {}

    def add(c, side):
        out[(c, side * side)] = out.get((c, side * side), 0) + 1

    side, c = img // 2, 64
    add(c, side)
    side //= 2
    for b, n in enumerate((6, 12, 24, 16)):
        for layer in range(n):
            add(c + 32 * layer, side)
            add(128, side)
        c += 32 * n
        if b < 3:
            add(c, side)
            c, side = c // 2, side // 2
    add(c, side)
    return out


# train.densenet256's step: two trunks at 256 px, the 256-px decoders (a
# sixth block) and the word text networks
DENSENET = {cs: 2 * n for cs, n in densenet_trunk(256).items()}
for _cs, _n in {(64, 16384): 2, (64, 4096): 6, (64, 1024): 6, (128, 256): 6, (256, 64): 3,
                (192, 64): 6, (64, 128): 1, (256, 32): 3, (320, 16): 3, (64, 64): 2,
                (128, 32): 3, (256, 16): 6, (192, 16): 3, (320, 8): 3, (256, 8): 3,
                (320, 4): 3, (256, 4): 3, (256, 2): 3, (320, 1): 7}.items():
    DENSENET[_cs] = DENSENET.get(_cs, 0) + _n
MAIN_SHAPES = sorted(set(WORD) | set(CHAR) | set(DENSENET), key=lambda cs: -cs[0] * cs[1])
BATCH = 256
EPS, MOMENTUM = 1e-5, 0.1


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_main_path_counts():
    assert sum(WORD.values()) == 96 and sum(CHAR.values()) == 108
    assert sum(DENSENET.values()) == 314 and len(DENSENET) == 81


def test_densenet_trunk_shapes_are_the_modules():
    """``densenet_trunk`` at 64 px against the BatchNorms a forward of the
    port's trunk meets, shape by shape."""
    from mopoe_mimic_tpu_torch.models.densenet import DenseNet121

    trunk, met = DenseNet121(), {}

    def hook(mod, inp, out):
        cs = (inp[0].shape[1], inp[0][0, 0].numel())
        met[cs] = met.get(cs, 0) + 1

    for mod in trunk.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        trunk(torch.rand(2, 1, 64, 64))
    assert met == densenet_trunk(64) and sum(met.values()) == 121


# ---------------------------------------------------------------------------
# CPU: routing, the plain version, the wrapper's checks, the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,training,kernels", [
    ("cuda", torch.bfloat16, True, True),
    ("cuda", torch.float32, True, False),
    ("cuda", torch.bfloat16, False, False),
    ("cpu", torch.bfloat16, True, False),
    ("cpu", torch.float32, True, False),
])
def test_routing_by_device_dtype_and_mode(device, dtype, training, kernels):
    bn = nn.BatchNorm2d(4).train(training)
    x = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert resblocks.takes_bn_kernels(x, bn) is kernels


@pytest.mark.parametrize("bn_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("training", [True, False])
def test_cpu_blocks_call_their_modules(monkeypatch, bn_dtype, training):
    """On the CPU every BatchNorm of a block is its module's call, never
    the op."""
    def refuse(x, bn):
        raise AssertionError("the op ran on the CPU")

    monkeypatch.setattr(resblocks, "batch_norm_train", refuse)
    torch.manual_seed(0)
    blk = ResidualBlock2dConv(4, 6, bn_dtype=bn_dtype).train(training)
    calls = []
    for name in ("bn1", "bn2", "downsample.1"):
        blk.get_submodule(name).register_forward_hook(lambda m, i, o, n=name: calls.append(n))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        blk(torch.randn(3, 4, 8, 8))
    assert calls == ["bn1", "bn2", "downsample.1"]


def _twin_modules(kind, C, seed):
    torch.manual_seed(seed)
    a = kind(C)
    with torch.no_grad():
        a.weight.uniform_(0.5, 1.5)
        a.bias.normal_()
        a.running_mean.normal_()
        a.running_var.uniform_(0.5, 1.5)
    b = kind(C)
    b.load_state_dict(a.state_dict())
    return a.train(), b.train()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shape", [(nn.BatchNorm2d, (5, 3, 4, 6)),
                                        (nn.BatchNorm1d, (7, 4, 9)),
                                        (nn.BatchNorm1d, (6, 8, 1))])
def test_plain_version_is_the_module(kind, shape, dtype):
    """Two steps of the op on the CPU against the module: the output, the
    running statistics, num_batches_tracked and the gradients of x,
    weight and bias bit for bit."""
    mod, op = _twin_modules(kind, shape[1], seed=len(shape))
    for step in range(2):
        x = torch.randn(shape, generator=torch.Generator().manual_seed(step)).to(dtype)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        ya, yb = mod(xa), batch_norm_train(xb, op)
        assert ya.dtype == yb.dtype == dtype and torch.equal(ya, yb)
        g = torch.randn(shape).to(dtype)
        ya.backward(g)
        yb.backward(g)
        assert torch.equal(xa.grad, xb.grad)
    for name, t in mod.state_dict().items():
        assert torch.equal(t, op.state_dict()[name]), name
    assert int(op.num_batches_tracked) == 2
    for pa, pb in zip(mod.parameters(), op.parameters()):
        assert pa.grad.dtype == torch.float32 and torch.equal(pa.grad, pb.grad)


def test_op_refuses_a_module_without_affine_or_statistics():
    with pytest.raises(ValueError, match="affine"):
        batch_norm_train(torch.randn(2, 3, 4), nn.BatchNorm1d(3, affine=False).train())
    with pytest.raises(ValueError, match="affine"):
        batch_norm_train(torch.randn(2, 3, 4), nn.BatchNorm1d(3, momentum=None).train())


def _channels(C, dtype=torch.float32):
    return [torch.ones(C, dtype=dtype) for _ in range(4)]


@pytest.mark.parametrize("x,error,match", [
    (torch.zeros(2, 3, 4), TypeError, "bfloat16"),
    (torch.zeros(2, 3, 4, 5, dtype=torch.bfloat16), ValueError, r"\[N, C, S\]"),
    (torch.zeros(2, 4, 3, dtype=torch.bfloat16).transpose(1, 2), ValueError, "contiguous"),
    (torch.zeros(2, 3, 4, dtype=torch.bfloat16), ValueError, "CUDA"),
])
def test_wrapper_raises_on_what_the_kernels_do_not_take(x, error, match):
    with pytest.raises(error, match=match):
        cuda_batchnorm.bn_fwd_cuda(x, *_channels(3), EPS, MOMENTUM)
    with pytest.raises(error, match=match):
        cuda_batchnorm.bn_bwd_cuda(x, x, *_channels(3)[:3])


def _groups(plan, C):
    return math.ceil(C / (cuda_batchnorm.THREADS // plan.tpc))


@pytest.mark.parametrize("C,S", MAIN_SHAPES + [(3, 7), (64, 1), (5, 7000)])
@pytest.mark.parametrize("N", [BATCH, 8, 4096])
def test_plan_covers_the_batch_and_fills_the_card(N, C, S):
    vec = 8 if S % 8 == 0 else 1
    plan = cuda_batchnorm.bn_plan(N, C, S, vec)
    items = N * (S // vec)
    assert plan.vec == vec and plan.tpc & (plan.tpc - 1) == 0
    if plan.fused:  # one pass: the channel's slice in its lanes' registers
        assert items <= cuda_batchnorm.THREADS * cuda_batchnorm.HELD
        assert math.ceil(items / plan.tpc) <= cuda_batchnorm.HELD
        assert plan.tpc <= cuda_batchnorm.THREADS and (plan.chunks, plan.b_per_chunk) == (1, N)
        return
    assert items > cuda_batchnorm.THREADS * cuda_batchnorm.HELD
    assert plan.tpc <= min(32, S // vec)
    assert (plan.chunks - 1) * plan.b_per_chunk < N <= plan.chunks * plan.b_per_chunk
    lane_items = plan.b_per_chunk * (S // vec) / plan.tpc
    assert lane_items >= cuda_batchnorm.LANE_ITEMS or plan.chunks == 1
    # the fewest b a chunk that keep to TARGET_BLOCKS blocks: one b fewer
    # would pass it, unless a lane's least work sets the chunk
    least = math.ceil(cuda_batchnorm.LANE_ITEMS * plan.tpc / (S // vec))
    assert (plan.b_per_chunk in (1, least)
            or _groups(plan, C) * math.ceil(N / (plan.b_per_chunk - 1))
            > cuda_batchnorm.TARGET_BLOCKS)


def test_main_path_plans():
    """Which design each main-path shape takes at batch 256: one pass
    where the slice fits (a channel's ≤ 16384 elements in 16-byte items,
    ≤ 2048 in single ones), two passes beyond."""
    fused = {(C, S) for C, S in MAIN_SHAPES
             if cuda_batchnorm.bn_plan(BATCH, C, S, 8 if S % 8 == 0 else 1).fused}
    assert fused == {(C, S) for C, S in MAIN_SHAPES if S <= 64}


@pytest.mark.parametrize("C,S", MAIN_SHAPES + [(3, 7), (64, 1), (5, 7000), (12, 5000)])
@pytest.mark.parametrize("N", [BATCH, 8, 4096])
def test_nhwc_plan_covers_the_rows_and_fills_the_card(N, C, S):
    """The channels-innermost plan of x [R = N·S, C]: one pass where each
    of a cluster's blocks holds R / CLUSTER rows, at most HELD_ROWS a lane;
    else a block of every column (up to THREADS), chunks of at least
    CHUNK_ROWS rows that cover R, no more blocks than TARGET_BLOCKS unless
    a lane's least work or the least chunk sets the chunk."""
    R, vec = N * S, 8 if C % 8 == 0 else 1
    plan = cuda_batchnorm.bn_plan_nhwc(R, C, vec)
    V, rps = C // vec, cuda_batchnorm.THREADS // plan.cols
    per_block = math.ceil(R / cuda_batchnorm.CLUSTER)
    assert plan.vec == vec and 1 <= plan.cols <= min(V, cuda_batchnorm.THREADS)
    if plan.fused:
        assert (plan.chunks, plan.rows_per_chunk) == (cuda_batchnorm.CLUSTER, per_block)
        assert plan.cols == min(V, cuda_batchnorm.CLUSTER_COLS)
        assert math.ceil(per_block / rps) <= cuda_batchnorm.HELD_ROWS
        return
    cluster_rps = cuda_batchnorm.THREADS // min(V, cuda_batchnorm.CLUSTER_COLS)
    assert math.ceil(per_block / cluster_rps) > cuda_batchnorm.HELD_ROWS
    assert plan.cols == min(V, cuda_batchnorm.THREADS)
    assert (plan.chunks - 1) * plan.rows_per_chunk < R <= plan.chunks * plan.rows_per_chunk
    assert plan.chunks <= 65535 and plan.rows_per_chunk >= cuda_batchnorm.CHUNK_ROWS
    lane_items = plan.rows_per_chunk / rps
    assert lane_items >= cuda_batchnorm.LANE_ITEMS or plan.chunks == 1
    tiles = math.ceil(V / plan.cols)
    assert (tiles * plan.chunks <= cuda_batchnorm.TARGET_BLOCKS
            or plan.rows_per_chunk in (cuda_batchnorm.LANE_ITEMS * rps,
                                       cuda_batchnorm.CHUNK_ROWS))


@pytest.mark.parametrize("R,C,vec,fused,cols", [
    (256 * 4096, 64, 8, False, 8),  # the resnet cells' largest map: 16-byte items, two passes
    (256 * 256, 1024, 8, False, 128),  # DenseNet block 3's widest: a block of 2 rows a step
    (256 * 64, 1024, 8, False, 128),  # 8×8 maps: two passes
    (256 * 16, 320, 8, True, 8),  # 4×4 maps: a cluster 8 columns, 16 rows a lane
    (256, 320, 8, True, 8),  # 1×1: 1 row a lane
    (256 * 256, 12, 1, False, 12),  # C not a multiple of 8: one channel an item
    (7, 3, 1, True, 3),
])
def test_nhwc_plan_loads_and_passes(R, C, vec, fused, cols):
    plan = cuda_batchnorm.bn_plan_nhwc(R, C, vec)
    assert (plan.vec, plan.fused, plan.cols) == (vec, fused, cols)


@pytest.mark.parametrize("R,C,vec", [(0, 8, 8), (8, 0, 8), (8, 12, 8), (8, 8, 4), (8, 8, 16)])
def test_nhwc_plan_refuses_what_the_kernels_do_not_take(R, C, vec):
    with pytest.raises(ValueError, match="bn_plan_nhwc"):
        cuda_batchnorm.bn_plan_nhwc(R, C, vec)


def test_nhwc_main_path_plans():
    """At batch 256 every main-path C takes 16-byte items; one pass for
    maps of up to 16 elements (R ≤ 4096: 4×4 at most in 2-D), two passes
    beyond."""
    fused = {(C, S) for C, S in MAIN_SHAPES
             if cuda_batchnorm.bn_plan_nhwc(BATCH * S, C, 8).fused}
    assert all(C % 8 == 0 for C, _ in MAIN_SHAPES)
    assert fused == {(C, S) for C, S in MAIN_SHAPES if S <= 16}


@pytest.mark.parametrize("x,error,match", [
    (torch.zeros(6, 8), TypeError, "bfloat16"),
    (torch.zeros(2, 3, 8, dtype=torch.bfloat16), ValueError, r"\[R, C\]"),
    (torch.zeros(8, 6, dtype=torch.bfloat16).t(), ValueError, "contiguous"),
    (torch.zeros(6, 8, dtype=torch.bfloat16), ValueError, "CUDA"),
])
def test_nhwc_wrapper_raises_on_what_the_kernels_do_not_take(x, error, match):
    C = x.shape[-1]
    with pytest.raises(error, match=match):
        cuda_batchnorm.bn_fwd_nhwc_cuda(x, *_channels(C), EPS, MOMENTUM)
    with pytest.raises(error, match=match):
        cuda_batchnorm.bn_bwd_nhwc_cuda(x, x, *_channels(C)[:3])


_CL = torch.channels_last


@pytest.mark.parametrize("make,nhwc,copied", [
    (lambda: torch.zeros(2, 8, 3, 5).contiguous(memory_format=_CL), True, False),
    (lambda: torch.zeros(2, 8, 1, 1), True, False),  # [N, C, 1, 1]: the same memory either way
    (lambda: torch.zeros(2, 8, 3, 5), False, False),
    (lambda: torch.zeros(2, 8, 7), False, False),
    (lambda: torch.zeros(2, 8, 3, 5), True, True),
    (lambda: torch.zeros(2, 5, 3, 8).permute(0, 3, 2, 1), True, True),
    (lambda: torch.zeros(2, 7, 8).transpose(1, 2), False, True),
])
def test_the_op_reads_either_layout_in_place_and_counts_a_copy(make, nhwc, copied):
    """``readable``: a tensor in the plan's layout as it is; any other
    copied once into it and counted in ``bn_copies``. A channels-last x is
    the [N·H·W, C] matrix of its memory, and back, as views."""
    t, before = make(), cuda_batchnorm.LAUNCHES["bn_copies"]
    got = B.readable(t, nhwc)
    assert (got is not t) == copied
    assert cuda_batchnorm.LAUNCHES["bn_copies"] - before == int(copied)
    assert B.channels_last(got) if nhwc else got.is_contiguous()
    assert torch.equal(got, t)
    if nhwc:
        rows = B._as_rows(got)
        assert rows.data_ptr() == got.data_ptr() and rows.is_contiguous()
        back = B._like(rows, got, True)
        assert torch.equal(back, got) and B.channels_last(back)


# ---------------------------------------------------------------------------
# CPU: the channels-last 2-D networks
# ---------------------------------------------------------------------------

def _net(kind, channels_last):
    from mopoe_mimic_tpu_torch.models.img_networks import DecoderImg, EncoderImg

    torch.manual_seed(3)
    if kind == "decoder":
        return DecoderImg(2, 4, 64, channels_last=channels_last)
    return EncoderImg(2, 4, 64, feature_extractor=kind, channels_last=channels_last)


def _net_input(kind):
    g = torch.Generator().manual_seed(4)
    return torch.randn(2, 4, generator=g) if kind == "decoder" else torch.rand(2, 1, 64, 64,
                                                                                  generator=g)


def _train_step(net, x):
    """Forward (dropout drawn from one seed), a loss on every output,
    backward, one fused Adam step: (outputs, optimizer)."""
    opt = torch.optim.Adam(net.parameters(), lr=1e-3, fused=True)
    torch.manual_seed(5)
    out = net(x)
    out = out if isinstance(out, tuple) else (out,)
    sum((o * torch.linspace(-1, 1, o.numel(), dtype=o.dtype).view(o.shape)).sum()
        for o in out).backward()
    opt.step()
    return [o.detach() for o in out], opt


@pytest.mark.parametrize("kind", ["resnet", "decoder", "densenet"])
def test_channels_last_networks_train_as_the_nchw_ones(kind):
    """One train step of a channels-last network against the NCHW one from
    the same weights and dropout draws. Every 4-D tensor a module takes or
    gives is channels-last (but the DenseNet stem's input, the grayscale
    image repeated to 3 channels, a broadcast view in either layout), and
    so is every BatchNorm's output gradient (the kernels then copy none),
    every conv weight, its gradient and Adam's states. In float64: the
    outputs within 1e-12 of their largest and every gradient within 1e-12
    of the network's largest (measured 1.5e-14 and 6e-14, the DenseNet). In
    float32 the two layouts' sums in other orders flip ReLU masks at these
    2-row batches (BatchNorms over 8 elements a channel at the DenseNet's
    2×2 maps), and a flipped mask moves every gradient below it by a few
    per cent: a difference the layouts do not make."""
    nchw, cl = _net(kind, False), _net(kind, True)
    assert all(torch.equal(a, b) for a, b in zip(nchw.state_dict().values(),
                                                  cl.state_dict().values()))
    not_cl = []

    def forward_hook(mod, inputs, output):
        for t in (*inputs, output):
            if (isinstance(t, torch.Tensor) and t.dim() == 4
                    and not t.is_contiguous(memory_format=_CL)):
                not_cl.append(mod)

    def backward_hook(mod, grad_in, grad_out):
        if not grad_out[0].is_contiguous(memory_format=_CL):
            not_cl.append((mod, "output gradient"))

    for mod in cl.modules():
        if mod is not cl:
            mod.register_forward_hook(forward_hook)
        if isinstance(mod, nn.BatchNorm2d):
            mod.register_full_backward_hook(backward_hook)
    nchw.double(), cl.double()
    x = _net_input(kind).double()
    got, opt = _train_step(cl, x)
    want, _ = _train_step(nchw, x)
    stem = [cl.feature_extractor.features.conv0] if kind == "densenet" else []
    assert not_cl == stem, not_cl
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-12 * float(w.abs().max()), kind
    largest = max(float(q.grad.abs().max()) for q in nchw.parameters())
    for (name, p), q in zip(cl.named_parameters(), nchw.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-12 * largest, name
    for name, p in cl.named_parameters():
        if p.dim() == 4:
            state = opt.state[p]
            assert all(t.is_contiguous(memory_format=_CL)
                       for t in (p, p.grad, state["exp_avg"], state["exp_avg_sq"])), name


@pytest.mark.parametrize("channels", [1, 3])
def test_stem_and_head_as_matrix_products_are_the_modules(channels):
    """The channels-last networks' stem (``conv2d_rows``) and output layer
    (``conv_transpose2d_rows``) against the modules in float64, values and
    gradients; the stem's output channels-last."""
    from mopoe_mimic_tpu_torch.models.img_networks import conv2d_rows, conv_transpose2d_rows

    torch.manual_seed(6)
    cases = ((nn.Conv2d(channels, 8, 3, 2, 1, bias=False), (3, channels, 16, 16), conv2d_rows),
             (nn.ConvTranspose2d(8, channels, 3, 2, 1, output_padding=1),
              (3, 8, 8, 8), conv_transpose2d_rows))
    for mod, shape, rows in cases:
        mod = mod.double()
        x = torch.randn(shape, dtype=torch.float64).contiguous(memory_format=_CL)
        xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
        want, got = mod(xa), rows(xb, mod)
        assert got.shape == want.shape and torch.allclose(got, want, rtol=0, atol=1e-13)
        g = torch.randn(want.shape, dtype=torch.float64)
        w_want, x_want = torch.autograd.grad(want, (mod.weight, xa), g)
        w_got, x_got = torch.autograd.grad(got, (mod.weight, xb), g)
        assert torch.allclose(w_got, w_want, rtol=0, atol=1e-12)
        assert torch.allclose(x_got, x_want, rtol=0, atol=1e-12)
    assert B.channels_last(conv2d_rows(torch.zeros(2, channels, 8, 8), cases[0][0].float()))


@pytest.mark.parametrize("knobs,channels_last", [
    (dict(compute_dtype="bfloat16", bn_compute_dtype="compute"), True),
    (dict(compute_dtype="bfloat16", bn_compute_dtype="compute", fused_pointwise=True), False),
    (dict(compute_dtype="bfloat16"), False),  # float32 BatchNorms
    (dict(), False),
])
def test_only_networks_on_the_bf16_batchnorm_kernels_go_channels_last(knobs, channels_last):
    """``MMVae``'s rule: the image networks are channels-last where their
    BatchNorms run on the port's bf16 kernels; K3's networks
    (``fused_pointwise``) and float32 BatchNorms stay NCHW; text networks
    have no 4-D weight either way."""
    from mopoe_mimic_tpu_torch.config import MopoeConfig
    from mopoe_mimic_tpu_torch.models.mmvae import MMVae

    model = MMVae(MopoeConfig(dataset="testing", batch_size=4, class_dim=4, DIM_img=2,
                              DIM_text=2, img_size=64, vocab_size=30, **knobs))
    convs = [p for p in model.parameters() if p.dim() == 4]
    layout = _CL if channels_last else torch.contiguous_format
    assert convs and all(p.is_contiguous(memory_format=layout) for p in convs)
    # 1×1 kernels are both; the others tell the layouts apart
    assert any(not p.is_contiguous(memory_format=torch.contiguous_format if channels_last
                                   else _CL) for p in convs)
    assert all(model.encoder(m).channels_last == model.decoder(m).channels_last
               == channels_last for m in ("PA", "Lateral"))


# ---------------------------------------------------------------------------
# the card: the kernels against ATen's bf16 BatchNorm
# ---------------------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _build.load_library()
    return torch.device("cuda")


def _inputs(C, S, seed, device, n=BATCH):
    """x with a shift and a scale of its own a channel, dy with a bias (so
    that dβ does not cancel), float32 parameters and running buffers."""
    g = torch.Generator(device=device).manual_seed(seed)
    shift = torch.randn(C, generator=g, device=device) * 2
    scale = torch.rand(C, generator=g, device=device) * 3 + 0.1
    x = (torch.randn(n, C, S, generator=g, device=device) * scale[:, None]
         + shift[:, None]).bfloat16()
    dy = (torch.randn(n, C, S, generator=g, device=device) + 0.3).bfloat16()
    w = torch.rand(C, generator=g, device=device) + 0.5
    b = torch.randn(C, generator=g, device=device)
    rm = torch.randn(C, generator=g, device=device)
    rv = torch.rand(C, generator=g, device=device) + 0.5
    return x, dy, w, b, rm, rv


def _ulp(ref):
    """One bf16 ulp of |ref| (float64)."""
    r = ref.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(r)) - 7)


def _rows(t):
    """[N, C, S] → the same values channels-last, as the [N·S, C] matrix
    the channels-innermost kernels read."""
    return t.transpose(1, 2).contiguous().view(-1, t.shape[1])


def _kernels(x, dy, w, b, rm, rv, layout="ncs"):
    """Forward and backward on x, dy [N, C, S], on the plan of ``layout``
    (``nhwc``: the same values channels-last); y and dx as [N, C, S]."""
    rm, rv = rm.clone(), rv.clone()
    if layout == "ncs":
        y, mean, invstd = cuda_batchnorm.bn_fwd_cuda(x, w, b, rm, rv, EPS, MOMENTUM)
        dx, dw, db = cuda_batchnorm.bn_bwd_cuda(x, dy, w, mean, invstd)
        return y, mean, invstd, rm, rv, dx, dw, db
    N, C, S = x.shape
    x2 = _rows(x)
    y, mean, invstd = cuda_batchnorm.bn_fwd_nhwc_cuda(x2, w, b, rm, rv, EPS, MOMENTUM)
    dx, dw, db = cuda_batchnorm.bn_bwd_nhwc_cuda(x2, _rows(dy), w, mean, invstd)
    back = lambda t: t.view(N, S, C).transpose(1, 2)  # noqa: E731
    return back(y), mean, invstd, rm, rv, back(dx), dw, db


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ncs", "nhwc"])
@pytest.mark.parametrize("C,S", MAIN_SHAPES)
def test_kernels_match_aten(device, C, S, layout):
    x, dy, w, b, rm, rv = _inputs(C, S, 1000 * C + S, device)
    got = _kernels(x, dy, w, b, rm, rv, layout)
    y, mean, invstd, rm_k, rv_k, dx, dw, db = got
    rm_a, rv_a = rm.clone(), rv.clone()
    y_a, mean_a, invstd_a = torch.ops.aten.native_batch_norm(x, w, b, rm_a, rv_a, True,
                                                             MOMENTUM, EPS)
    assert all(torch.equal(a, c) for a, c in zip(got, _kernels(x, dy, w, b, rm, rv, layout)))

    xd = x.double()
    var64 = xd.var((0, 2), unbiased=False)
    spread = var64.sqrt()
    assert bool(((mean.double() - mean_a.double()).abs()
                 <= 1e-5 * mean_a.double().abs() + 2e-6 * spread).all())
    for got_c, ref_c, floor in ((invstd, invstd_a, 0.0), (rv_k, rv_a, 0.0),
                                (rm_k, rm_a, 2e-6 * MOMENTUM * spread)):
        assert bool(((got_c.double() - ref_c.double()).abs()
                     <= 1e-5 * ref_c.double().abs() + floor).all())

    xc = xd - mean.double()[:, None]
    terms = w.double().abs() * xc.abs().amax((0, 2)) * invstd.double() + b.double().abs()
    assert bool(((y.double() - y_a.double()).abs() <= _ulp(y_a) + 1e-5 * terms[:, None]).all())

    n = x.shape[0] * S
    inv64 = 1 / (var64 + EPS).sqrt()
    xc64 = xd - xd.mean((0, 2))[:, None]
    dyd = dy.double()
    db64, dot64 = dyd.sum((0, 2)), (dyd * xc64).sum((0, 2))
    assert bool(((db.double() - db64).abs()
                 <= 1e-4 * db64.abs() + 1e-6 * dyd.abs().sum((0, 2))).all())
    # dγ on the backward's own inputs: the saved mean and invstd
    xc_saved = xd - mean.double()[:, None]
    dw_saved = (dyd * xc_saved).sum((0, 2)) * invstd.double()
    assert bool(((dw.double() - dw_saved).abs()
                 <= 1e-4 * dw_saved.abs()
                 + 1e-6 * (dyd * xc_saved).abs().sum((0, 2)) * invstd.double()).all())
    # and end to end, where the saved mean's float32 error moves dγ by Σdy·δmean·invstd
    carried = (db64 * (mean.double() - xd.mean((0, 2)))).abs() * inv64
    assert bool(((dw.double() - dot64 * inv64).abs()
                 <= 1e-4 * (dot64 * inv64).abs()
                 + 1e-6 * (dyd * xc64).abs().sum((0, 2)) * inv64 + carried).all())
    proj = dot64 / n * inv64 ** 2
    dx64 = (dyd - xc64 * proj[:, None] - (db64 / n)[:, None]) * (inv64 * w.double())[:, None]
    dx_terms = ((dyd.abs().amax((0, 2)) + xc64.abs().amax((0, 2)) * proj.abs()
                 + (db64 / n).abs()) * inv64 * w.double().abs())
    assert bool(((dx.double() - dx64).abs() <= 2 * _ulp(dx64) + 1e-5 * dx_terms[:, None]).all())


def _bn_step(x, dy, bn):
    """The op's forward and backward on x, as a train step runs them; y
    detached, so that no autograd graph outlives the step (a capture must
    not meet the eager step's gradient accumulators)."""
    xr = x.clone().requires_grad_()
    y = batch_norm_train(xr, bn)
    y.backward(dy)
    return y.detach(), xr.grad


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ncs", "nhwc"])
@pytest.mark.parametrize("C,S", [(64, 1024), (256, 64), (320, 1)])
def test_a_replayed_graph_is_the_eager_call_and_counts_its_launches(device, C, S, layout):
    """Forward and backward captured in a CUDA graph and replayed from the
    module's state before an eager call: outputs, gradients and the
    running statistics bitwise the eager ones; ``LAUNCHES`` counts each
    replay's launches, not the capture's. ``nhwc``: a BatchNorm2d on a
    channels-last x and dy, read in place (no ``bn_copies``)."""
    x, dy, *_ = _inputs(C, S, 7, device)
    if layout == "ncs":
        x, dy = x.reshape(BATCH, C, S), dy.reshape(BATCH, C, S)
        bn = nn.BatchNorm1d(C).to(device).train()
    else:
        side = math.isqrt(S)
        x, dy = (t.view(BATCH, C, side, side).contiguous(memory_format=torch.channels_last)
                 for t in (x, dy))
        bn = nn.BatchNorm2d(C).to(device).train()
    start = {k: v.clone() for k, v in bn.state_dict().items()}

    def restore():  # in place: the graph holds the addresses
        with torch.no_grad():
            for k, v in bn.state_dict().items():
                v.copy_(start[k])
            for p in bn.parameters():
                if p.grad is not None:
                    p.grad.zero_()

    y_e, dx_e = _bn_step(x, dy, bn)
    eager = ({k: v.clone() for k, v in bn.state_dict().items()},
             [p.grad.clone() for p in bn.parameters()])
    restore()
    static_x, static_dy = x.clone(), dy.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _bn_step(static_x, static_dy, bn)  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    restore()
    graph = torch.cuda.CUDAGraph()
    out = {}

    def capture():
        with torch.cuda.graph(graph):
            out["y"], out["dx"] = _bn_step(static_x, static_dy, bn)

    launches = _build.uncounted(capture)
    per_call = {"bn_fwd": 1, "bn_bwd": 1, "bn_fwd_nhwc": 0, "bn_bwd_nhwc": 0, "bn_copies": 0}
    if layout == "nhwc":
        per_call.update(bn_fwd_nhwc=1, bn_bwd_nhwc=1)
    assert {name: n for _, name, n in launches} == {k: n for k, n in per_call.items() if n}
    before = dict(cuda_batchnorm.LAUNCHES)
    for _ in range(3):
        graph.replay()
        _build.add_launches(launches)
    assert {k: v - before[k] for k, v in cuda_batchnorm.LAUNCHES.items()} == {
        k: 3 * n for k, n in per_call.items()}
    if layout == "nhwc":
        assert B.channels_last(out["y"]) and B.channels_last(out["dx"])
    torch.cuda.synchronize()
    assert torch.equal(out["y"], y_e) and torch.equal(out["dx"], dx_e)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    for k, v in bn.state_dict().items():
        assert torch.equal(v, eager[0][k]), k
    assert all(torch.equal(p.grad, g) for p, g in zip(bn.parameters(), eager[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("x_layout,gy_layout,copies,nhwc", [
    ("channels_last", "channels_last", 0, True),
    ("contiguous", "contiguous", 0, False),
    ("channels_last", "contiguous", 1, True),  # gy copied into x's layout
    ("contiguous", "channels_last", 1, False),
    ("neither", "channels_last", 1, True),  # x copied to channels-last
])
def test_the_op_copies_only_what_is_in_neither_layout(device, x_layout, gy_layout, copies,
                                                      nhwc):
    """``batch_norm_train`` on a 4-D x and gy in the layouts given:
    ``bn_copies`` counts the inputs it copied, the plan follows x, and y,
    dx match the all-channels-last call bitwise."""
    x, dy, *_ = _inputs(64, 64, 11, device)
    x, dy = x.view(BATCH, 64, 8, 8), dy.view(BATCH, 64, 8, 8)
    lay = {"channels_last": lambda t: t.contiguous(memory_format=torch.channels_last),
           "contiguous": lambda t: t.contiguous(),
           "neither": lambda t: t.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)}
    runs = []
    for xl, gl in ((x_layout, gy_layout), ("channels_last", "channels_last")):
        bn = nn.BatchNorm2d(64).to(device).train()
        before = dict(cuda_batchnorm.LAUNCHES)
        xr = lay[xl](x).clone(memory_format=torch.preserve_format).requires_grad_()
        y = batch_norm_train(xr, bn)
        y.backward(lay[gl](dy))
        added = {k: v - before[k] for k, v in cuda_batchnorm.LAUNCHES.items()}
        runs.append((y.detach(), xr.grad, added))
    (y, dx, added), (y_cl, dx_cl, _) = runs
    assert added["bn_copies"] == copies
    assert added["bn_fwd_nhwc"] == added["bn_bwd_nhwc"] == int(nhwc)
    assert added["bn_fwd"] == added["bn_bwd"] == 1
    if nhwc:
        assert torch.equal(y, y_cl) and torch.equal(dx, dx_cl)


@pytest.mark.cuda
@pytest.mark.parametrize("bn_dtype,training,launched", [(torch.bfloat16, True, 3),
                                                        (torch.float32, True, 0),
                                                        (torch.bfloat16, False, 0)])
@pytest.mark.parametrize("block", [ResidualBlock2dConv, ResidualBlock1dConv])
def test_blocks_on_the_card_route_by_dtype_and_mode(device, block, bn_dtype, training,
                                                    launched):
    torch.manual_seed(0)
    blk = block(8, 16, bn_dtype=bn_dtype).to(device).train(training)
    x = torch.randn((4, 8, 16, 16) if block is ResidualBlock2dConv else (4, 8, 32),
                    device=device)
    before = dict(cuda_batchnorm.LAUNCHES)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        blk(x)
    assert cuda_batchnorm.LAUNCHES["bn_fwd"] - before["bn_fwd"] == launched


@pytest.mark.cuda
@pytest.mark.parametrize("encoding,per_step", [("word", 96), ("char", 108), ("densenet", 314)])
def test_every_bf16_batchnorm_of_a_replayed_step_launches(device, encoding, per_step):
    """After the capture, N replays of the graphed epoch add N times the
    step's BatchNorms to both entry points: every train-mode bf16
    BatchNorm of the flagship's networks, and of the DenseNet trunks at 256 px,
    goes through the kernels; those of the channels-last image networks
    (every ``BatchNorm2d``) on the channels-innermost plan. One input is
    copied a step where the word text head is fused (K2): the word
    decoder's last block's shortcut BatchNorm gets its gradient from K2's
    backward, which writes it [B, L, C], the transpose of the block's
    [B, C, L] (the parent copied the same gradient in the op's
    ``gy.contiguous()``); none otherwise."""
    from mopoe_mimic_tpu_torch.config import MopoeConfig
    from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
    from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
    from mopoe_mimic_tpu_torch.train.scan import epoch_index_matrix, make_train_epoch
    from mopoe_mimic_tpu_torch.train.state import create_train_state

    densenet = encoding == "densenet"
    cfg = MopoeConfig(dataset="testing", batch_size=4, class_dim=4, DIM_img=4, DIM_text=4,
                      img_size=256 if densenet else 128,
                      text_encoding="word" if densenet else encoding, vocab_size=30,
                      feature_extractor_img="densenet" if densenet else "resnet",
                      compute_dtype="bfloat16", bn_compute_dtype="compute",
                      fused_text_head=encoding != "char", lr_warmup_steps=3)
    store = DeviceStore(SyntheticMimic(cfg, seed=0, length=16), cfg, device=device)
    state = create_train_state(cfg, device, seed=1)
    modules = [m for m in state.model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    assert len(modules) == per_step
    image_nets = [net for net in state.model.children() if getattr(net, "channels_last", False)]
    assert len(image_nets) == 4  # the PA and Lateral encoders and decoders
    nhwc = sum(isinstance(m, nn.BatchNorm2d) for net in image_nets for m in net.modules())
    assert nhwc == sum(isinstance(m, nn.BatchNorm2d) for m in modules)
    train_epoch = make_train_epoch(cfg, store)
    rows = epoch_index_matrix(store, 0, cfg.batch_size)
    train_epoch(state, rows[:1])  # the warm-up and the capture
    before = dict(cuda_batchnorm.LAUNCHES)
    train_epoch(state, rows)
    added = {k: v - before[k] for k, v in cuda_batchnorm.LAUNCHES.items()}
    assert added == {**dict.fromkeys(("bn_fwd", "bn_bwd"), per_step * len(rows)),
                     **dict.fromkeys(("bn_fwd_nhwc", "bn_bwd_nhwc"), nhwc * len(rows)),
                     "bn_copies": int(cfg.fused_text_head) * len(rows)}, added
