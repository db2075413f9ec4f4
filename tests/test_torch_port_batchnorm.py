"""The port's train-mode BatchNorm (``ops/batchnorm.py``, the kernels of
``csrc/batchnorm.cu`` behind ``ops/cuda_batchnorm.py``) and its routing in
``models/resblocks.py``.

CPU cases (one intra-op thread, no JAX): CPU tensors, float32 BatchNorms
and eval mode go to the module unchanged; the op's plain version equals
``nn.BatchNorm{1,2}d`` in train mode bit for bit (output, running
statistics, ``num_batches_tracked``, gradients); the wrapper raises on
what the kernels do not take; the plan of the kernels' grid.

Card cases (marked ``cuda``, skipped without a CUDA device; this file
imports neither jax nor the JAX package, so on a machine without them
run ``python -m pytest --noconftest -m cuda tests/test_torch_port_batchnorm.py``):
the kernels against ATen's bf16 BatchNorm (``native_batch_norm`` and its
backward, what ``nn.BatchNorm`` runs for a bf16 input with float32
weights) at every main-path shape of the word, char and DenseNet-121
(``train.densenet256``) configurations.
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
from mopoe_mimic_tpu_torch.ops import _build, cuda_batchnorm
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


def _kernels(x, dy, w, b, rm, rv):
    rm, rv = rm.clone(), rv.clone()
    y, mean, invstd = cuda_batchnorm.bn_fwd_cuda(x, w, b, rm, rv, EPS, MOMENTUM)
    dx, dw, db = cuda_batchnorm.bn_bwd_cuda(x, dy, w, mean, invstd)
    return y, mean, invstd, rm, rv, dx, dw, db


@pytest.mark.cuda
@pytest.mark.parametrize("C,S", MAIN_SHAPES)
def test_kernels_match_aten(device, C, S):
    x, dy, w, b, rm, rv = _inputs(C, S, 1000 * C + S, device)
    got = _kernels(x, dy, w, b, rm, rv)
    y, mean, invstd, rm_k, rv_k, dx, dw, db = got
    rm_a, rv_a = rm.clone(), rv.clone()
    y_a, mean_a, invstd_a = torch.ops.aten.native_batch_norm(x, w, b, rm_a, rv_a, True,
                                                             MOMENTUM, EPS)
    assert all(torch.equal(a, c) for a, c in zip(got, _kernels(x, dy, w, b, rm, rv)))

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
@pytest.mark.parametrize("C,S", [(64, 1024), (256, 64), (320, 1)])
def test_a_replayed_graph_is_the_eager_call_and_counts_its_launches(device, C, S):
    """Forward and backward captured in a CUDA graph and replayed from the
    module's state before an eager call: outputs, gradients and the
    running statistics bitwise the eager ones; ``LAUNCHES`` counts each
    replay's launches, not the capture's."""
    x, dy, *_ = _inputs(C, S, 7, device)
    x, dy = x.reshape(BATCH, C, S), dy.reshape(BATCH, C, S)
    bn = nn.BatchNorm1d(C).to(device).train()
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
    assert {name: n for _, name, n in launches} == {"bn_fwd": 1, "bn_bwd": 1}
    before = dict(cuda_batchnorm.LAUNCHES)
    for _ in range(3):
        graph.replay()
        _build.add_launches(launches)
    assert {k: v - before[k] for k, v in cuda_batchnorm.LAUNCHES.items()} == {"bn_fwd": 3,
                                                                             "bn_bwd": 3}
    torch.cuda.synchronize()
    assert torch.equal(out["y"], y_e) and torch.equal(out["dx"], dx_e)
    restore()
    graph.replay()
    torch.cuda.synchronize()
    for k, v in bn.state_dict().items():
        assert torch.equal(v, eager[0][k]), k
    assert all(torch.equal(p.grad, g) for p, g in zip(bn.parameters(), eager[1]))


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
    goes through the kernels."""
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
    train_epoch = make_train_epoch(cfg, store)
    rows = epoch_index_matrix(store, 0, cfg.batch_size)
    train_epoch(state, rows[:1])  # the warm-up and the capture
    before = dict(cuda_batchnorm.LAUNCHES)
    train_epoch(state, rows)
    added = {k: v - before[k] for k, v in cuda_batchnorm.LAUNCHES.items()}
    assert added == dict.fromkeys(("bn_fwd", "bn_bwd"), per_step * len(rows)), added
