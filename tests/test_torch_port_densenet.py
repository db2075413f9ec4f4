"""DenseNet-121 as the port's X-ray feature extractor
(mopoe_mimic_tpu_torch/models/densenet.py), float32 on the CPU at 64 px,
batch 4, on seeded weights:

* against the benchmark's plain reference (bench_port/reference/densenet.py):
  the encoder's forward in train and eval mode, the gradient of every
  leaf, the running statistics; a reference with one BatchNorm in bfloat16
  fails the same tolerances;
* against the JAX package's ``EncoderImg(feature_extractor="densenet")``
  through ``state_dict_from_jax``: one forward in each mode and the
  running statistics (the JAX side's variables from ``eval_shape`` and
  seeded noise, its applies jitted: a traced init and eager applies of the
  121 layers take a minute);
* ``fixed_image_extractor``, the state-dict keys, serving's ``encode``, and
  the counters against ``bench_port/metrics/_work_densenet.py``;
* the cell ``train.densenet256`` through ``run.execute`` at a CPU size
  (``bench_port/tests/_small.py``'s widths, 64 px, float32): its check
  passes, and the ``unchanged``, ``half_batch`` and ``control`` faults fail
  it; the per-layer readers give None where nothing was profiled;
* ``_work_densenet``: the 224-px trunk against torchvision's count, the
  forward against the port's modules, the 256-px step against the hand count
  in PERF.md.
"""

import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch import nn

from mopoe_mimic_tpu.models import img_networks as JI
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models import densenet as TD
from mopoe_mimic_tpu_torch.models import img_networks as TI
from mopoe_mimic_tpu_torch.models.jax_import import state_dict_from_jax
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import make_train_step

BENCH_DIR = Path(__file__).resolve().parent.parent / "bench_port"
for _p in (str(BENCH_DIR / "tests"), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import _small  # noqa: E402
import run as bench_run  # noqa: E402
from metrics import _work, _work_densenet  # noqa: E402
from reference import densenet as RD  # noqa: E402
from reference import mmvae as RM  # noqa: E402
from reference.training import seeded_weights  # noqa: E402

DIM, CLASS_DIM, BATCH, IMG = 4, 6, 4, 64
CFG = MopoeConfig(text_encoding="word", vocab_size=30, img_size=IMG, DIM_img=DIM,
                  DIM_text=DIM, class_dim=CLASS_DIM, batch_size=BATCH,
                  compute_dtype="float32", feature_extractor_img="densenet")
# float32 against float32 through 121 BatchNorms: the two sides run the same
# CPU convolutions, and differ where a BatchNorm's statistics are summed in
# another order (autograd's against the reference's recomputed layers).
# Measured gaps are under 1e-6 of the largest value; a bfloat16 BatchNorm
# anywhere moves them past 1e-3.
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_close(got, ref, what=""):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(ref).all(), what
    atol = ATOL * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=atol, err_msg=what)


def seeded(model: nn.Module, seed: int) -> dict:
    """``reference/training.seeded_weights`` with seeded noise on every
    BatchNorm's scale, shift and running statistics, so that each matters
    (running variances 0.5-2 keep eval-mode activations O(1))."""
    weights = seeded_weights(model, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in weights.items():
        if k.endswith(("norm0.weight", "norm1.weight", "norm2.weight", "norm.weight",
                       "norm5.weight")):
            weights[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith(("running_mean", ".bias")) and "norm" in k:
            weights[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            weights[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
    return weights


def images(seed: int, batch: int = BATCH, size: int = IMG) -> torch.Tensor:
    return torch.rand((batch, 1, size, size), generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def pair():
    """(the port's encoder, the reference's) on the same seeded weights."""
    ref = RD.Encoder(DIM, CLASS_DIM)
    port = TI.EncoderImg(DIM, CLASS_DIM, IMG, feature_extractor="densenet")
    weights = seeded(ref, 7)
    ref.load_state_dict(weights)
    port.load_state_dict(weights)
    return port, ref


def ref_forward(ref, x, training, nm=None):
    return ref.run(x, nm or RM.Numerics(), training)


def test_forward_matches_the_reference(pair):
    port, ref = pair
    x = images(1)
    with torch.no_grad():
        for training in (True, False):
            port.train(training)
            got = port(x)
            want = ref_forward(ref, x, training)
            for g, w, name in zip(got, want, ("mu", "logvar")):
                assert_close(g, w, f"{name}, train={training}")
            port.load_state_dict(ref.state_dict())  # a train-mode forward moves the statistics


def test_gradients_and_running_statistics_match_the_reference(pair):
    port, ref = pair
    x = images(2)
    gen = torch.Generator().manual_seed(3)
    r = [torch.randn((BATCH, CLASS_DIM), generator=gen) for _ in range(2)]

    def loss(out):
        return sum((o * w).sum() for o, w in zip(out, r))

    port.train()
    for p in list(port.parameters()) + list(ref.parameters()):
        p.grad = None
    loss(port(x)).backward()
    loss(ref_forward(ref, x, True)).backward()  # each dense layer recomputed
    ref_grads = dict(ref.named_parameters())
    named = list(port.named_parameters())
    assert len(named) == len(ref_grads)
    for k, p in named:
        assert_close(p.grad, ref_grads[k].grad, k)
    want = RD.running_statistics(ref, x)
    got = port.state_dict()
    assert len(want) == 2 * 121
    for k, v in want.items():
        assert_close(got[k], v, k)
    port.load_state_dict(ref.state_dict())


def test_one_bf16_batchnorm_fails_the_tolerances(pair, monkeypatch):
    """The tolerances would catch a BatchNorm computed one precision down:
    the reference with ``denseblock2.denselayer3.norm1`` in bfloat16."""
    port, ref = pair
    x = images(4)
    target = ref.feature_extractor.features.denseblock2.denselayer3.norm1
    plain = RD._norm

    def norm(mod, h, training, nm, track):
        if mod is target:
            y = plain(mod, h.bfloat16().float(), training, nm, track)
            return y.bfloat16().float()
        return plain(mod, h, training, nm, track)

    monkeypatch.setattr(RD, "_norm", norm)
    port.train()
    with torch.no_grad():
        got, want = port(x), ref_forward(ref, x, True)
    with pytest.raises(AssertionError):
        for g, w in zip(got, want):
            assert_close(g, w)
    port.load_state_dict(ref.state_dict())


# ---------------------------------------------------------------- the JAX module

def _jax_variables(module, x, seed):
    """The module's variables by ``eval_shape`` (no traced init), each leaf
    seeded noise: scales and shifts about 1 and 0, running variances 0.5-2,
    kernels within PyTorch's default bound."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=s.shape)).astype(np.float32)
        bound = 1.0 / math.sqrt(math.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_matches_the_jax_module_through_jax_import():
    """The JAX trunk (its BatchNorms float32, as the port's are in a float32
    model) with ``feature_compressor``, converted by ``state_dict_from_jax``.
    Tolerances as tests/test_torch_port_modules.py's: float32 convolutions of
    another library, and JAX's one-pass variance E[x²] − μ²."""
    jm = JI.EncoderImg(DIM, CLASS_DIM, img_size=IMG, feature_extractor="densenet")
    x = np.asarray(images(5).permute(0, 2, 3, 1))
    variables = _jax_variables(jm, x, 11)
    sd = state_dict_from_jax({"params": {"encoder_PA": variables["params"]},
                              "batch_stats": {"encoder_PA": variables["batch_stats"]}}, CFG)
    port = TI.EncoderImg(DIM, CLASS_DIM, IMG, feature_extractor="densenet")
    port.load_state_dict({k.removeprefix("encoder_pa."): v for k, v in sd.items()})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()

    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    port.eval()
    with torch.no_grad():
        got = port(xt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))

    want, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    port.train()
    with torch.no_grad():
        got = port(xt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))
    updated = state_dict_from_jax({"params": {"encoder_PA": variables["params"]},
                                   "batch_stats": {"encoder_PA": jax.device_get(
                                       mut["batch_stats"])}}, CFG)
    mine = port.state_dict()
    stats = [k for k in updated if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 121
    for k in stats:
        w = updated[k].numpy()
        np.testing.assert_allclose(mine[k.removeprefix("encoder_pa.")].numpy(), w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=k)


# ---------------------------------------------------------------- the model around it

def test_state_dict_keys_are_torchvisions():
    """torchvision's densenet121 keys under ``feature_extractor.features``,
    then ``proj``; the reference's keys are the same."""
    port = TI.EncoderImg(DIM, CLASS_DIM, IMG, feature_extractor="densenet")
    keys = set(port.state_dict())
    assert keys == set(RD.Encoder(DIM, CLASS_DIM).state_dict())
    fe = "feature_extractor."
    for k in ("features.conv0.weight", "features.norm0.running_var",
              "features.denseblock1.denselayer6.norm1.weight",
              "features.denseblock4.denselayer16.conv2.weight",
              "features.transition3.norm.num_batches_tracked", "features.transition3.conv.weight",
              "features.norm5.bias", "proj.weight", "proj.bias"):
        assert fe + k in keys, k
    assert "feature_compressor.content_mu.weight" in keys
    bns = [m for m in port.modules() if isinstance(m, nn.BatchNorm2d)]
    convs = [m for m in port.modules() if isinstance(m, nn.Conv2d)]
    assert (len(bns), len(convs)) == (121, 120)
    assert all(m.eps == 1e-5 and m.momentum == 0.1 for m in bns)
    assert all(m.bias is None for m in convs)
    assert port.feature_extractor.proj.weight.shape == (5 * DIM, 1024)


@pytest.mark.parametrize("bn", ["float32", "compute"])
def test_every_batchnorm_takes_bn_compute_dtype(bn):
    cfg = CFG.replace(bn_compute_dtype=bn, compute_dtype="bfloat16")
    model = MMVae(cfg)
    trunk = model.encoder_pa.feature_extractor.features
    want = torch.bfloat16 if bn == "compute" else torch.float32
    owners = [m for m in trunk.modules() if hasattr(m, "bn_dtype")]
    assert len(owners) == 1 + 58 + 3 and all(m.bn_dtype == want for m in owners)


def test_fixed_image_extractor_trains_proj_and_the_statistics_alone():
    cfg = CFG.replace(fixed_image_extractor=True, dataset="testing")
    state = create_train_state(cfg, device="cpu", seed=0)
    model = state.model
    trunk = model.encoder_pa.feature_extractor.features
    assert not any(p.requires_grad for p in trunk.parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    batch = {"PA": torch.rand((BATCH, 1, IMG, IMG), generator=gen),
             "Lateral": torch.rand((BATCH, 1, IMG, IMG), generator=gen),
             "text": torch.randint(1, 30, (BATCH, 128), generator=gen)}
    make_train_step(cfg)(state, batch)
    after = model.state_dict()
    pre = "encoder_pa.feature_extractor."
    assert torch.equal(after[pre + "features.conv0.weight"], before[pre + "features.conv0.weight"])
    assert all(torch.equal(after[k], before[k]) for k, _ in trunk.named_parameters(prefix=pre +
                                                                                    "features"))
    assert not torch.equal(after[pre + "features.norm0.running_mean"],
                           before[pre + "features.norm0.running_mean"])
    assert not torch.equal(after[pre + "proj.weight"], before[pre + "proj.weight"])


def test_serving_encode_is_the_references_eval_forward():
    """``InferenceSession.encode`` of PA alone: its subset's mean is the
    reference encoder's in eval mode (a single expert's product is itself)."""
    model = RD.MMVae(RD.model_sizes({"DIM_img": DIM, "DIM_text": DIM, "class_dim": CLASS_DIM,
                                     "text_encoding": "word", "vocab_size": 30,
                                     "img_size": IMG}))
    weights = seeded(model, 13)
    model.load_state_dict(weights)
    session = InferenceSession(CFG, weights, device="cpu")
    x = images(6, batch=3)
    out = session.encode({"PA": x.permute(0, 2, 3, 1).numpy()})
    with torch.no_grad():
        mu, _ = model.encoder_pa.run(x, RM.Numerics(), False)
    assert_close(out["subsets"]["PA"][0], mu, "PA mu")


def test_counters_are_the_works_count():
    """A trunk's forward counts its 58 dense layers and the bytes their
    concatenations read and write, as ``_work_densenet`` counts them."""
    trunk = TD.DenseNet121()
    before = dict(TD.COUNTS)
    with torch.no_grad():
        trunk(images(8, batch=2))
    added = {k: v - before[k] for k, v in TD.COUNTS.items()}
    assert added["densenet.layers"] == sum(_work_densenet.BLOCK_CONFIG) == 58
    assert added["densenet.concat_bytes"] == 2 * 4 * _work_densenet.concat_elements(2, IMG)


# ---------------------------------------------------------------- the benchmark's cell

def _cell(workload: str):
    bench, entry, c, config = _small.cell(workload)
    config["config"].update(img_size=IMG, compute_dtype="float32")
    return bench, entry, c, config


@pytest.mark.parametrize("fault", ["", "unchanged", "half_batch", "control"])
def test_cell_check_passes_and_faults_fail(fault):
    """The program in float32 against the float32 reference passes the
    cell's committed limits; each fault fails them."""
    bench, entry, c, config = _cell("train.densenet256")
    line, compared, readings = bench_run.execute(bench, entry, c, config, "train.densenet256",
                                                 2 ** 31 + 11, 1.0, False, "cpu", fault=fault)
    assert line["correct"] is (fault == "")
    assert readings["densenet_counts"]["densenet.layers"] == 2 * 58
    if fault == "":
        assert all(v < lim / 10 for v, lim in compared.values()), compared


def test_driver_refuses_to_replace_a_global_its_copy_lacks():
    """The driver's private copies of ``drivers/train.py`` and
    ``reference/training.py`` take their replaced globals by name: a name
    the copied file lacks raises rather than leaving the copy on its own."""
    drv = bench_run.load_module(BENCH_DIR / "drivers" / "train_densenet.py", "t_train_densenet")
    assert drv.base.MMVae is RD.MMVae and drv.training.MMVae is RD.MMVae
    assert drv.base.reference_steps is drv.training.reference_steps
    with pytest.raises(AttributeError, match="no global 'reference_stepz'"):
        drv._copy_of(BENCH_DIR / "drivers" / "train.py", "t_train_copy", reference_stepz=None)


def test_readers_give_none_without_a_profile():
    readings = {"profile": None, "window_epochs": 0, "config": {}, "densenet_counts": {}}
    for name in ("networks.concat_ms", "networks.concat_roofline", "step.mfu_densenet"):
        mod = bench_run.load_module(BENCH_DIR / "metrics" / f"{name}.py", f"t_{name}")
        assert mod.read(readings) is None


# ---------------------------------------------------------------- the work counts

def test_work_trunk_is_torchvisions_count():
    """At 224 px and 3 channels the trunk and a 1000-way classifier are
    torchvision's 2.834 G multiply-adds for densenet121, within 1%."""
    macs = sum(_work_densenet.trunk_ops(1, 224).values()) / 2 + 1024 * 1000
    assert macs == pytest.approx(2.834e9, rel=0.01)


def test_work_forward_matches_the_ports_modules():
    """Every convolution, transposed convolution and linear the port's model
    calls in a forward, counted by hooks from their shapes."""
    total = [0]

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, (nn.ConvTranspose1d, nn.ConvTranspose2d)):
            total[0] += 2 * x.numel() * mod.out_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
            total[0] += 2 * out.numel() * mod.in_channels * math.prod(mod.kernel_size)
        elif isinstance(mod, nn.Linear):
            total[0] += 2 * x.numel() * mod.out_features

    keys = dict(_small.CELL_FILES("train.densenet256")[3]["config"], batch_size=2,
                img_size=IMG, compute_dtype="float32", bn_compute_dtype="float32")
    model = MMVae(MopoeConfig(**keys)).train()
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d,
                          nn.Linear)):
            m.register_forward_hook(hook)
    gen = torch.Generator().manual_seed(0)
    batch = {"PA": torch.rand((2, 1, IMG, IMG), generator=gen),
             "Lateral": torch.rand((2, 1, IMG, IMG), generator=gen),
             "text": torch.randint(1, 50, (2, 128), generator=gen)}
    with torch.no_grad():
        model(batch, generator=gen)
    assert sum(_work_densenet.forward_ops(keys).values()) == total[0]


def test_work_step_is_perfs_hand_count():
    """The cell's step at 256 px, batch 256 (PERF.md, Cells): the two trunks
    11.367 TFLOP of 14.147."""
    cfg = _small.CELL_FILES("train.densenet256")[3]["config"]
    assert (cfg["img_size"], cfg["batch_size"]) == (256, 256)
    assert sum(_work_densenet.trunk_ops(1, 256).values()) == 7_400_849_408
    assert _work_densenet.train_step_ops(cfg) == 14_147_257_368_576
    assert _work_densenet.concat_bytes(cfg) == 27_212_644_352
    assert _work_densenet.train_step_ops(cfg) > 4 * _work.train_step_ops(
        _small.CELL_FILES("train.word128")[3]["config"])
