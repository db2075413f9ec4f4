"""Typed configuration of the port: the JAX package's ``MopoeConfig``.

A copy of ``mopoe_mimic_tpu/config.py`` (standard library only), kept so
that the port reads no file of the JAX package: the same fields, defaults,
derived properties, ``from_json``, ``replace``, ``to_dict`` and the
command-line parser (``parser``, ``from_namespace``, ``from_cli``), so both
packages read the same ``config.json`` and the same command line. tests/test_torch_port_config.py
holds the two dataclasses equal. The TPU-named knobs select the port's
CUDA kernels on CUDA tensors: ``use_pallas_fusion`` K1, ``fused_text_head``
K2, ``fused_pointwise`` K3.

As there, one frozen dataclass replaces the reference's two-tier argparse
flag system (mimic/utils/BaseFlags.py:4-113 and mimic/utils/flags.py:23-175). Field names match the reference flags where a counterpart
exists, so configs written for the reference map 1:1. JSON configs overlay
the defaults and the command line overlays the JSON
(mimic/utils/flags.py:117-128 `update_flags_with_config`).

Derived quantities reproduced from the reference:
  * ``alpha_modalities`` = [div_weight_uniform_content, div_weight_m1_content,
    div_weight_m2_content, div_weight_m3_content] (flags.py:172-175)
  * ``len_sequence`` forced to 128 for word encoding / 1024 for char
    encoding (flags.py:157)
  * ``method`` expansion to fusion booleans (filehandling.py:101-113) is
    handled by the :class:`Method` enum instead of four mutually exclusive
    boolean flags.
"""

from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import string
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the 71-character alphabet of char-level text, as mopoe_mimic_tpu/data/alphabet.py
# builds it; only its length is needed here
ALPHABET: str = "\n" + "\t" + " " + string.punctuation + string.digits + string.ascii_lowercase


class Method(str, enum.Enum):
    """Multimodal fusion method (reference: --method flag, get_method at
    mimic/utils/filehandling.py:101-113)."""

    POE = "poe"
    MOE = "moe"
    JSD = "jsd"
    JOINT_ELBO = "joint_elbo"  # MoPoE

    @property
    def uses_poe_fusion(self) -> bool:
        # BaseMMVae.set_fusion_functions (mimic/utils/BaseMMVae.py:51-69)
        return self in (Method.POE, Method.JOINT_ELBO)

    @property
    def uses_dynamic_prior(self) -> bool:
        return self is Method.JSD


class TextEncoding(str, enum.Enum):
    CHAR = "char"
    WORD = "word"


@dataclass(frozen=True)
class MopoeConfig:
    """All knobs of the framework. Frozen → hashable → safe as a jit static."""

    # ----- method ---------------------------------------------------------
    method: str = "joint_elbo"

    # ----- training (BaseFlags.py:11-21) ----------------------------------
    seed: Optional[int] = None
    batch_size: int = 256
    initial_learning_rate: float = 1e-3
    beta_1: float = 0.9
    beta_2: float = 0.999
    start_epoch: int = 0
    end_epoch: int = 100
    steps_per_training_epoch: int = -1

    # ----- model dims -----------------------------------------------------
    class_dim: int = 20
    style_pa_dim: int = 0
    style_lat_dim: int = 0
    style_text_dim: int = 0
    image_channels: int = 1
    img_size: int = 128
    DIM_img: int = 128
    DIM_text: int = 128
    factorized_representation: bool = False
    feature_extractor_img: str = "resnet"  # resnet | densenet
    # freeze the DenseNet trunk (stop_gradient on its features): only the
    # projection/classifier head trains. Reference flags.py:31 defaults
    # True because its trunk is ImageNet-pretrained (CheXNet.py:20-25,
    # 36-44); here trunks train from scratch unless torch-converted
    # weights are loaded (models/torch_import.py), so the default is off.
    fixed_image_extractor: bool = False

    # ----- likelihoods (flags.py:64-66) ------------------------------------
    likelihood_m1: str = "laplace"
    likelihood_m2: str = "laplace"
    likelihood_m3: str = "categorical"

    # ----- text -------------------------------------------------------------
    text_encoding: str = "char"
    len_sequence: int = 1024  # derived: 128 (word) / 1024 (char), flags.py:157
    word_min_occ: int = 3
    text_gen_lastlayer: str = "softmax"  # none | softmax | sigmoid
    vocab_size: int = 3517  # word-encoding vocab; testing default matches
    # Mimic_testing (mimic/dataio/MimicDataset.py:408)

    # ----- loss weights (BaseFlags.py:103-113, flags.py:96-122) -------------
    beta: float = 5.0
    beta_style: float = 1.0
    beta_content: float = 1.0
    beta_m1_style: float = 1.0
    beta_m2_style: float = 1.0
    beta_m3_style: float = 1.0
    div_weight_m1_content: float = 0.25
    div_weight_m2_content: float = 0.25
    div_weight_m3_content: float = 0.25
    div_weight_uniform_content: float = 0.25
    rec_weight_m1: float = 0.33
    rec_weight_m2: float = 0.33
    rec_weight_m3: float = 0.33

    # ----- dataset ----------------------------------------------------------
    # 'Mimic' | 'testing' (shape-parity noise fixture, Mimic_testing parity)
    # | 'testing_structured' (learnable synthetic: shared latent class
    #   across modalities — noise can't exercise the eval metrics)
    dataset: str = "Mimic"
    synthetic_length: int = 0  # testing* train-split size; 0 → 2·batch_size
    synthetic_classes: int = 3  # latent classes in testing_structured
    # per-channel corruption prob in testing_structured (data/synthetic.py):
    # >0 de-saturates eval metrics so they can rank model quality
    synthetic_noise: float = 0.0
    only_text_modality: bool = False
    undersample_dataset: bool = False
    weighted_sampler: bool = False
    binary_labels: bool = False
    # read the 100-row toy slice (toy_files_small_*) written by
    # tensor_builder.create_toy_set instead of the full store
    use_toy_dataset: bool = False
    # input-pipeline lookahead: how many assembled host batches may be in
    # flight in prefetch_to_device (the TPU-native analog of the
    # reference's DataLoader worker count — here one producer thread with
    # N-deep pipelining, since batch assembly is vectorized gathers, not
    # per-sample Python). Each in-flight batch holds host+device memory.
    dataloader_workers: int = 2

    # ----- evaluation toggles (BaseFlags.py:69-90) --------------------------
    use_clf: bool = False
    calc_nll: bool = False
    eval_lr: bool = False
    calc_prd: bool = False
    save_figure: bool = False
    eval_freq: int = 10
    eval_freq_fid: int = 10
    num_samples_fid: int = 10000
    num_training_samples_lr: int = 500
    num_imp_samples: int = 6  # IWAE importance samples (likelihood.py:120)
    # heavy-eval coverage: 0 → the FULL test set, like the reference's
    # test() pass (mimic/run_epochs.py:148-228); >0 caps each heavy eval at
    # that many test batches (and says so in the log — no silent caps).
    eval_max_batches: int = 0
    # heavy-eval batch size: 0 → the training batch size (one compiled
    # program per shape — the TPU-friendly default, PARITY.md deviations);
    # set 30 for the reference's forced eval batch (run_epochs.py:188),
    # which makes per-batch-averaged metric GROUPINGS match it exactly.
    eval_batch_size: int = 0
    # coherence-classifier training depth: 0 → train to mean-AP/dice
    # early-stop convergence like the reference
    # (mimic/networks/classifiers/utils.py:130-203); >0 → that many quick
    # epochs (smoke-test mode).
    clf_quick_epochs: int = 0

    # ----- classifiers ------------------------------------------------------
    text_clf_type: str = "word"
    img_clf_type: str = "resnet"  # resnet | densenet
    clf_loss: str = "binary_crossentropy"
    # early-stop patience for the classifier workload, DECOUPLED from the
    # VAE's max_early_stopping_index (the reference trains classifiers as a
    # separate CLI with its own flags): a VAE run that disables its own
    # early stop (e.g. patience 1000 to record a full trajectory) must not
    # silently force coherence classifiers to train max_epochs each.
    clf_early_stop_patience: int = 5
    # Five/TenCrop(224) for the densenet classifier path (reference
    # flags.n_crops; crop-mean at main_train_clf_mimic.py:67-72): 1 | 5 | 10
    n_crops: int = 1

    # ----- callbacks --------------------------------------------------------
    reduce_lr_on_plateau: bool = False
    max_early_stopping_index: int = 5
    start_early_stopping_epoch: int = 0
    checkpoint_freq: int = 50  # save every N epochs (experiment.py:388-402)
    # also checkpoint whenever the test loss improves (beyond the
    # reference, which only saves every 50 epochs). A full-state save
    # device_gets params+opt_state — worth skipping on slow links where
    # early training improves every epoch.
    checkpoint_on_improvement: bool = True

    # ----- directories ------------------------------------------------------
    dir_data: str = "../data"
    dir_experiment: str = "/tmp/mopoe_tpu_runs"
    dir_clf: str = "../clf"
    dir_fid: Optional[str] = None
    inception_state_dict: str = "../inception_state_dict.pth"
    exp_str_prefix: str = "Mimic"

    # global-norm gradient clipping; 0 disables (the reference has none —
    # it relies on NaN-restart supervision instead; clipping tames the
    # violent early-training landscape at lr ≥ 5e-4)
    grad_clip_norm: float = 0.0
    # linear update ramp over the first N steps (0 = off): the opt-in
    # stability fix for the 1x1-spatial BN blow-up at lr 5e-4
    # (docs/STABILITY.md; train/state.make_optimizer)
    lr_warmup_steps: int = 0

    # BatchNorm epsilon for the residual-block networks. torch default
    # 1e-5 = reference parity. The encoders end in BN at 1×1 spatial whose
    # batch variance collapses toward eps on unstructured inputs
    # (docs/STABILITY.md root-cause analysis); raising bn_eps (e.g. 1e-3)
    # caps that amplification as an opt-in stability mode — the
    # architecture and every other default stay untouched.
    bn_eps: float = 1e-5

    # Reference-parity parameter init: torch's layer defaults
    # (kaiming_uniform(a=sqrt(5)) kernels + uniform biases + N(0,1)
    # embeddings) instead of this package's he_normal + zero-bias flax
    # idiom (models/torch_init.py). The reference sets no custom
    # initializers anywhere, so its from-scratch trajectories start from
    # this distribution; the round-5 convergence race isolates the
    # init-family effect on the converged ELBO (RESULTS_r5.md §1b).
    torch_init: bool = False

    # ----- TPU-native knobs (no reference counterpart) ----------------------
    compute_dtype: str = "bfloat16"  # matmul/conv compute dtype
    param_dtype: str = "float32"
    # BatchNorm normalize/affine dtype in the residual-block networks.
    # "float32" = round-1/2 behavior (every BN output and the BN/ReLU
    # activations saved for the backward pass are f32 even in bf16 mode);
    # "compute" runs that math in compute_dtype, halving the bytes of the
    # dominant activation traffic on a step that is HBM-bandwidth-bound
    # (BENCH.md round-3). Batch statistics and running stats stay float32
    # either way (flax promotes stat computation internally).
    bn_compute_dtype: str = "float32"  # "float32" | "compute" | dtype name
    # "blocks": jax.checkpoint each residual block — save only block
    # inputs, recompute interiors in the backward pass. "conv": policy
    # remat — save only conv outputs, recompute the elementwise
    # BN/ReLU/dropout interiors (cheap FLOPs, no saved-activation
    # traffic). Trades saved-activation reads for recompute writes;
    # measured by benchmarks/bench_step_diet.py before changing any
    # default (BENCH.md step-diet table).
    remat: str = "none"  # "none" | "blocks" | "conv"
    # render eval-round sample grids on the experiment's host worker
    # thread instead of blocking the eval round (evaluation/runner.py);
    # rendering overlaps the next scanned epoch and is drained at end of
    # run. False = synchronous (deterministic timing for profiling).
    async_plots: bool = True
    data_axis: str = "data"  # mesh axis the batch is sharded over
    mesh_shape: Tuple[int, ...] = ()  # () → all local devices on data axis
    # donate train state buffers to the step. Default off: buffer donation
    # intermittently deadlocks the first execution on the XLA *CPU* backend
    # (observed on 1-core hosts); enable on real TPU for in-place updates.
    donate_state: bool = False
    # quantize float input modalities (images, char one-hots) to uint8 for
    # the host→device transfer and dequantize (/255) on device: 4× less
    # transfer volume — the input pipeline is the wall-clock bottleneck
    # when feeding over a slow link or many hosts. Exact for {0,1} one-hots
    # and for uint8-sourced JPEG pixels; ≤1/510 quantization noise for
    # resized float images. Off by default (bit-parity with the reference).
    transfer_uint8: bool = False
    # park the ENTIRE dataset in HBM as a compact store (uint8 images, id
    # text) and gather batches on device — per-step host→device transfer
    # collapses to the [B] index vector. The TPU-native answer to the
    # reference's load-everything-into-host-RAM (MimicDataset.py:42-43);
    # MIMIC at 128px uint8 is ~2.1 GB (DeviceStore.fits() pre-checks the
    # budget). Off by default: streaming is the general path.
    device_resident_data: bool = False
    # with device_resident_data: run each train/test pass as ONE jitted
    # lax.scan over the epoch's steps (train/scan.py) — one dispatch and
    # one host read per epoch instead of one per step. Same numerics as
    # the per-step path; turn off to debug individual steps.
    scan_epochs: bool = True
    # fuse the all-subsets PoE into one Pallas VMEM kernel (TPU only —
    # trace-time platform check falls back to the XLA masked-sum path
    # elsewhere). Bit-identical outputs, ~20% faster flagship train step.
    use_pallas_fusion: bool = True
    # fuse the word-text vocab head (1x1 conv → log_softmax → target
    # gather) into one Pallas kernel inside the train/eval objective: the
    # [B, L, vocab] logits stay in VMEM tiles and the backward recomputes
    # them on the MXU (ops/pallas_texthead.py). ~2.3 GB/step less HBM
    # traffic on the flagship. Only takes effect for word encoding with
    # len_sequence 128 and the softmax last layer; the kernel accumulates
    # the logits in float32 (slightly MORE precise than the unfused bf16
    # path), hence opt-in rather than the parity default.
    fused_text_head: bool = False
    # Compute every residual block's opening BN → ReLU → 1×1 conv as one
    # Pallas kernel in train mode (ops/pallas_pointwise.py): a pointwise
    # conv IS a matmul, so the BN/ReLU activations XLA would otherwise
    # materialize for the conv custom-call (and save for its backward)
    # never touch HBM; the custom VJP recomputes them in VMEM tiles and
    # implements the full train-mode BatchNorm backward. f32 normalize +
    # f32 matmul accumulation ≈ parity numerics (not bitwise) — opt-in
    # production knob like fused_text_head. Parameter tree unchanged.
    fused_pointwise: bool = False
    # Dropout masks recomputed from the PRNG key in the backward pass
    # (ops/rng_dropout.py custom VJP) instead of kept as residuals:
    # bit-identical sampling to flax Dropout (same key, same formula), so
    # trajectories are unchanged; trades a second bernoulli evaluation
    # for residual HBM traffic on the bandwidth-bound step. Accept/reject
    # by the step-diet protocol (benchmarks/bench_step_diet.py).
    rng_recompute_dropout: bool = False
    # NB on BatchNorm under data parallelism: the reference's DDP computes
    # BN statistics per replica (no sync-BN). Under single-controller GSPMD
    # jit the batch mean/var are computed over the GLOBAL sharded batch —
    # i.e. this framework is synchronized-BN by construction (XLA inserts
    # the collective). Identical at 1 device; statistically stronger at N.
    # Documented as a deviation in PARITY.md.

    # =========================================================================
    # derived values
    # =========================================================================

    def __post_init__(self):
        # force len_sequence like the reference (flags.py:157)
        forced = 128 if self.text_encoding == "word" else 1024
        object.__setattr__(self, "len_sequence", forced)

    @property
    def method_enum(self) -> Method:
        return Method(self.method)

    @property
    def effective_eval_batch_size(self) -> int:
        """Heavy-eval batch size: cfg.eval_batch_size, or the training
        batch size when 0 (see the eval_batch_size field note)."""
        return self.eval_batch_size or self.batch_size

    @property
    def text_encoding_enum(self) -> TextEncoding:
        return TextEncoding(self.text_encoding)

    @property
    def alpha_modalities(self) -> List[float]:
        """flags.py:172-175."""
        return [
            self.div_weight_uniform_content,
            self.div_weight_m1_content,
            self.div_weight_m2_content,
            self.div_weight_m3_content,
        ]

    @property
    def num_features(self) -> int:
        """Feature count of the text one-hot/vocab axis.

        char: alphabet size (71); word: vocab size. Mirrors
        flags.num_features setup in MimicExperiment.
        """
        if self.text_encoding == "char":
            return len(ALPHABET)
        return self.vocab_size

    @property
    def modality_names(self) -> Tuple[str, ...]:
        if self.only_text_modality:
            return ("text",)
        return ("PA", "Lateral", "text")

    @property
    def style_dims(self) -> Dict[str, int]:
        return {
            "PA": self.style_pa_dim,
            "Lateral": self.style_lat_dim,
            "text": self.style_text_dim,
        }

    @property
    def rec_weights(self) -> Dict[str, float]:
        # MimicExperiment.set_rec_weights semantics: per-modality rec weights
        return {
            "PA": self.rec_weight_m1,
            "Lateral": self.rec_weight_m2,
            "text": self.rec_weight_m3,
        }

    @property
    def style_weights(self) -> Dict[str, float]:
        return {
            "PA": self.beta_m1_style,
            "Lateral": self.beta_m2_style,
            "text": self.beta_m3_style,
        }

    @property
    def likelihoods(self) -> Dict[str, str]:
        return {
            "PA": self.likelihood_m1,
            "Lateral": self.likelihood_m2,
            "text": self.likelihood_m3,
        }

    # =========================================================================
    # construction helpers
    # =========================================================================

    def replace(self, **kw) -> "MopoeConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_json(cls, path: str, **overrides) -> "MopoeConfig":
        """JSON overlay like update_flags_with_config (flags.py:117-128).

        Unknown keys in the JSON are ignored with a warning (the reference
        configs carry cluster-specific path keys we don't need).
        """
        with open(path, "rt") as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = {k: v for k, v in raw.items() if k in known}
        cfg.update(overrides)
        return cls(**cfg)

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        """A command line with one flag a field (booleans as
        ``--flag true|false``) and ``--config_path``."""
        p = argparse.ArgumentParser(description=__doc__)
        p.add_argument("--config_path", type=str, default=None)
        for f in dataclasses.fields(cls):
            name = f"--{f.name}"
            if f.type in ("bool", bool):
                p.add_argument(name, type=_str2bool, default=None)
            elif f.type in ("int", int, "Optional[int]"):
                p.add_argument(name, type=int, default=None)
            elif f.type in ("float", float, "Optional[float]"):
                p.add_argument(name, type=float, default=None)
            elif f.name == "mesh_shape":
                p.add_argument(name, type=_int_tuple, default=None)
            else:
                p.add_argument(name, type=str, default=None)
        return p

    @classmethod
    def from_namespace(cls, args: argparse.Namespace) -> "MopoeConfig":
        """A config from a parsed namespace: the JSON of ``config_path``
        (if given) under the flags that were set."""
        known = {f.name for f in dataclasses.fields(cls)}
        overrides = {k: v for k, v in vars(args).items() if v is not None and k in known}
        if getattr(args, "config_path", None):
            return cls.from_json(args.config_path, **overrides)
        return cls(**overrides)

    @classmethod
    def from_cli(cls, argv: Optional[Sequence[str]] = None) -> "MopoeConfig":
        return cls.from_namespace(cls.parser().parse_args(argv))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _str2bool(v: str) -> bool:
    # flags.py:12-20 semantics
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _int_tuple(v: str) -> Tuple[int, ...]:
    return tuple(int(x) for x in v.split(",") if x)

