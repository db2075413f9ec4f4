#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero, printing no result, without one.
Imports the port (``mopoe_mimic_tpu_torch``), torch and numpy only. Phases,
any failure of which exits non-zero:

  1. device: the card's name, power limit and maximum SM clock (nvidia-smi);
  2. build: the CUDA kernels from ``mopoe_mimic_tpu_torch/csrc`` into
     ``build/kernels/``, one nvcc per source, all at once; ptxas's
     registers and spills of every instantiation of K1's kernels (none may
     spill); for the tensor-core kernels (K2's bfloat16 ``texthead_fwd``,
     ``texthead_bwd_dh``, ``texthead_bwd_dw``; K3's ``pointwise_fwd_tc``,
     ``pointwise_bwd_reduce_tc`` and ``pointwise_bwd_dx_tc``) ptxas's
     registers and spills and the count of HMMA/HGMMA instructions in their
     SASS (``cuobjdump -sass``), which must not be 0 in any instantiation;
  3. K1, forward and backward, against the plain versions on the card: the
     power-set kernels at M ∈ {1, 2, 3}, B ∈ {1, 5, 8, 32, 128, 256},
     D ∈ {64, 6}, with and without the prior expert, the experts given as
     separate tensors, as strided views and as a stacked pair; the generic
     kernels on four other masks: forward |Δ| ≤ 1e-6·max(1, |ref|), backward
     (against the closed form and autograd of the plain forward)
     ≤ 1e-5·max(1, |ref|), every case's forward also compared bitwise and
     counted; the backward under a saved-tensor hook that keeps host
     copies, with the forward's experts overwritten (it must read the
     tensors autograd gives back); then both
     kernels' device time at B ∈ {8, 128, 256} (profiler), both timed at
     those B against the plain versions, and the host's µs per call of each
     piece of one ``poe_subsets_cuda`` call (``k1_host_us``: 1000
     back-to-back calls of each);
     K2 (forward, dh, dW/db: in bfloat16 dW as row-split partials and their
     finalize) against the plain pair: (B, L, C, V) = (3, 17, 10, 37),
     (4, 128, 64, 3517) and the flagship (256, 128, 64, 3517) in float32
     with TF32 off (lp rtol 1e-5 atol 1e-5; dh, dW, db rtol 1e-4 atol
     1e-5; the plain pair accumulated in float64), and (3, 17, 10, 37),
     (3, 32, 24, 301), (2, 64, 128, 300) and the flagship in bfloat16 (lp
     and lse |Δ| ≤ 1e-5·max(1, |ref|): bf16 × bf16 products are exact in
     float32, so only the order of the sums and ex2 differ; each gradient
     |Δ| ≤ 2e-2·max|ref|), every
     case run twice and bitwise equal; each kernel timed at the flagship
     (dW with its finalize, and each alone), and the head as the model
     runs it, fused (K2) and unfused (bf16 autocast conv_out →
     log_softmax → target gather, PyTorch calls), forward and forward +
     backward;
     K3 (forward, pass A's partials and their finalize, pass B; in
     bfloat16 on tensor cores, ``pointwise_fwd_tc``, ``pointwise_bwd_reduce_tc``
     and ``pointwise_bwd_dx_tc``, in float32 on the CUDA cores) against
     the plain versions at the flagship's block shapes (B, C, Co, spatial) =
     (3, 64, 64, 5×5) with a conv bias, (256, 64, 64, 64×64) (the largest),
     (256, 320, 320, 1), (256, 320, 320, 4×4) and (256, 256, 256, 64)
     (1-D), W from a conv and from a transposed-conv weight: in float32
     with TF32 off against the plain versions accumulated in float64 (y and
     dx rtol 1e-5, dW, dcb, dγ, dβ rtol 1e-4, all atol 1e-5·max|ref|), and
     in bfloat16 (W, dy and x at every shape, as the blocks after a
     network's first get it under ``bn_compute_dtype="compute"``; and float32
     x too where the float32-BN flagship feeds it) against the
     plain versions on the same inputs (y |Δ| ≤ 1e-2·max|ref|, gradients
     2e-2·max|ref|), each bfloat16 case run twice and bitwise equal; each
     bfloat16 kernel timed at the largest block and at
     (256, 320, 320, 4×4) against its plain version (pass A as one
     function, its partials and their finalize together, against pass A's
     bound; its chunks and scratch bytes beside the bytes of its inputs),
     the float32 forward and pass A at the largest block, and the fused op
     against the unfused cuDNN composition (the block's bn1 → relu → conv1
     modules), forward and forward + backward; the fused op's statistics
     (``pointwise_stats`` and its finalize, with bn1's running update) at
     every K3 case's shape, x float32 and bfloat16: mean and var within
     1e-5·|ref| of a float64 oracle (the mean's floor 1e-6·sqrt(var)), inv
     within 1 ulp of 1/sqrt(var + eps) of the kernel's var, the running
     buffers within rtol 1e-6 (atol 1e-6·max|ref|) of the plain update, two
     runs bitwise equal;
     timed at K3_TIMED against the plain path (``batch_stats``,
     ``inv_std``, ``update_running_stats``) and ``torch.var_mean``;
     the bf16 train-mode BatchNorm (``bn_fwd``, ``bn_bwd``; one pass or
     two as ``bn_plan`` takes them; and the same values channels-last on
     ``bn_fwd_nhwc``, ``bn_bwd_nhwc`` as ``bn_plan_nhwc`` takes them) at
     ``BN_TIMED``: y within 1 bf16 ulp of
     ATen's, dx within 2 of a float64 reference (ATen's own dx measured
     against it), two runs bitwise equal, each kernel's device time beside
     the bound (10 bytes an element) and ATen's (``bn_against_aten``);
  4. the serving slice at the flagship configuration's full width
     (configs/flagship.json: 128 px, word text len 128, vocab 3517,
     DIM 64, class_dim 64; random weights from seed 0, randomised BN
     running statistics): ``encode`` of 40 rows, ``generate`` of 16 twice
     (identical), ``cond_generate`` of 8 rows full and compact, in float32
     and in bfloat16; outputs checked, K1's launch count > 0;
  5. the GPU session's ``encode`` (kernel) against a CPU session's (plain)
     on the same float32 weights with TF32 off: rtol 1e-4, atol
     1e-4·max|ref|, every subset and the joint;
  6. p50 latency of each endpoint at buckets 8 and 128;
  7. the training slice: the flagship with ``fused_text_head=True``, batch
     256, bfloat16, Adam at lr 5e-4 with ``lr_warmup_steps=300`` (without
     the ramp the architecture diverges within two steps on noise inputs,
     docs/STABILITY.md), weights from seed 0 and a seeded batch;
     3 warm-up and 10 timed steps. Every loss term finite, parameters and
     BN running statistics changed, grad_norm finite and > 0, and K1
     forward, K1 backward launched in every step, K2's four kernels
     exactly once and no K3 kernel; the step's p50 and samples/s, then a
     profile of 3 steps
     (device idle share, device ops a step, device time by kernel and the
     port's kernels'); then one step under PyTorch's sync debug mode, which
     prints each synchronizing operation and where it arose, and fails if
     one arose in the latent block (``ops/fusion.py``,
     ``ops/cuda_fusion.py``, ``models/mmvae.py``);
     then the same run with ``fused_pointwise=True`` as well, with each of
     K3's bfloat16 kernels (``pointwise_stats``, ``pointwise_stats_finalize``,
     ``pointwise_fwd_tc``, ``pointwise_bwd_reduce_tc``,
     ``pointwise_bwd_finalize``, ``pointwise_bwd_dx_tc``) launched exactly
     32 times per step (one per residual block) and the float32 forward and
     passes never, its p50, samples/s and profile beside the first; then
     both steps timed in turns (A B B A, 5 steps a turn), Σ of K3's bounds
     over one step's 32 blocks, each from its launch's inputs, and K3's
     device time at each of the step's block shapes (each kernel profiled
     through its own wrapper, by CUDA events where the profiler recorded
     none of it; beside the shape's bounds, and the plain path's
     statistics) summed over the step;
  8. one train step on the GPU (kernels) against one on the CPU (plain
     versions): flagship width, batch 8, float32, TF32 off, dropout 0,
     eps = 0, same weights: every loss term within rtol 1e-4; the gradients
     that the kernels produce or feed within 1e-3·max|g| of the tensor,
     all gradients within 1e-3 relative (L2), each within 1e-3·max|g| of
     the tensor plus 1e-3·max|g| of the model (float32's own floor on the
     tensors that are ill-conditioned at init: ``gpu_step_against_cpu``);
     then the same with ``fused_pointwise=True`` (K3's own accuracy is
     judged by phase 3), which launches K3's float32 kernels and the
     statistics and none of its bfloat16 ones;
  9. the epoch path, training A's main path: a ``SyntheticMimic`` of 16384
     rows (seed 0) in a ``DeviceStore`` on the card (its bytes, the growth
     of the allocated memory, a gathered batch bit for bit against the
     host's columns); 8 graphed steps (``make_train_epoch``, one row an
     epoch) against 8 eager ``make_train_step`` steps on the same
     ``epoch_index_matrix`` rows, from the same weights and generator state
     at flagship width, batch 8, float32, TF32 off, dropout 0: every loss
     term within rtol 1e-5 at every step, the parameters after within 1e-5
     relative L2, the generators' states equal and new after every step,
     and whether the two are bitwise equal; then training A through the
     graphed epoch: 13 steps (its capture included), every epoch mean
     finite, parameters and BN running statistics changed, K1 and K2
     launched by their wrappers and K3 not; a trace of 3 replays with K1
     forward and backward and K2's four kernels once a step and no K3
     kernel; a 3-step epoch under the sync debug mode with one
     synchronising operation, its read of the means; the graphed epoch and
     the eager store-fed loop in turns (G E E G, 20 steps a turn): ms a
     step from CUDA events, samples/s, and from a 3-step profile of each
     the device busy time, idle share and device ops a step; the gather's
     device time; then training B (``fused_pointwise`` too) the same way,
     each bf16 K3 kernel 32 times a replayed step and the float32 ones
     never; then training C (A with ``bn_compute_dtype="compute"``, the JAX
     production diet) the same way as A, its every BatchNorm through
     ``bn_fwd`` and ``bn_bwd`` (``bn_per_step``: 96 each a step, none in A
     or B), the 60 of its channels-last image networks through
     ``bn_fwd_nhwc`` and ``bn_bwd_nhwc``, one input copied a step
     (``bn_copies``: K2's transposed gradient),
     and C against A from the same
     weights, rows and dropout draws: 13 steps of each, C's total loss
     within 5e-2 relative of A's at every step; both in turns (A C C A, 20
     steps a turn), and a 3-step profile of each with BatchNorm's forward
     and backward device time;
 10. the training CLI at the flagship's full width, training C (batch 256,
     a 2048-row store, 2 epochs × 8 steps, a checkpoint every epoch, run
     directories under ``build/cli_runs``): ``python -m
     mopoe_mimic_tpu_torch.main`` in a process of its own exits 0 and leaves
     its run directory, ``config.json``, checkpoints and CSV row; the same
     run through ``main`` in this process launches K1 and K2 (counted) and
     no K3; 1 epoch, then ``--load_run`` for 1 more, equals the straight 2
     epochs bit for bit (parameters, BN buffers, Adam state, step count,
     generators); each epoch's train pass, test pass, callbacks and
     checkpoint write, and the loop's train pass a step against training
     C's ``make_train_epoch`` called directly; ``autotune_batch_size`` from
     256: each probe's peak and the batch picked. Last, an objective that
     waits for the host makes ``make_train_epoch`` raise (no eager
     fallback), the state unchanged;
 11. char-1024 text and serving from a run directory, at the flagship's
     full width: ``python -m mopoe_mimic_tpu_torch.main --text_encoding
     char`` (training C's diet, batch 256, 2 epochs × 8 steps of a
     2048-row store, a checkpoint each epoch, under ``build/char_runs``) in
     a process of its own exits 0 with its run directory; ``python -m
     mopoe_mimic_tpu_torch.serve --run_dir RUN --num_samples 16`` on it and
     on phase 10's word run exits 0, serves the checkpoint manager's best
     epoch (else its latest) and writes ``PA.png`` and ``Lateral.png`` (a
     PNG signature, the grid's size) and ``text_probs.npy`` [16, L,
     classes]; ``InferenceSession(run_dir=...)`` in this process restores
     that epoch, its ``encode`` of 40 rows bit for bit a state_dict
     session's, the slice's endpoints checked as in phase 4,
     ``text_array`` → ``cond_generate`` → ``decode_text`` giving 8
     strings, K1 launched and K2, K3 not, each endpoint's p50 at buckets 8
     and 128; one float32 char train step on the card against one on the
     CPU (phase 8's tolerances, K1 launched, K2 not; at the first batch
     seed from 14 at which a float32 step on the CPU moves by at most
     2.5e-4 under one-ulp nudges of the images: a point not within
     float32's rounding of a kink, a ReLU's or |x − loc|'s); char C against word
     C through the graphed epoch (2048-row stores): the launches, K1
     forward and backward once a replayed step and K2 never under char,
     one synchronising operation an epoch, both in turns (word char char
     word, 20 steps a turn, CUDA events) with a 3-step profile of each.
     Phase 3's K3 cases include the char networks' largest 1-D block
     (``char_block_shape``: C 64 at length 512);
 12. the evaluation suite at the flagship's full width, training C's diet,
     on ``testing_structured`` (run and classifier directories under
     ``build/eval_runs``): ``python -m mopoe_mimic_tpu_torch.main
     --config_path configs/flagship.json --dataset testing_structured`` with
     depth flags only (a 2048-row store, 8 steps an epoch, an eval round
     every epoch over 2 test batches, one quick classifier epoch, 6
     importance samples) and ``--save_figure``, in a process of its own for
     epoch 0, whose round trains the three classifiers and saves them as
     ``<dir>.pt``, and again with ``--load_run`` for epoch 1, whose round
     loads them from those files: each exits 0, the CSV row holds every
     lr-eval, coherence and likelihood value, TensorBoard each evaluation's
     scalars and the 10 grids at both epochs (where the package is
     installed), each epoch's 10 grids are PNG files of their sizes; then one eval round in this process on the run's last
     checkpoint, each evaluation timed with its launches counted (K1's
     forward in lr-eval, coherence, IWAE and the grids, no other kernel in
     the round), its results checked, the IWAE pass's peak memory, a
     3-batch profile of IWAE and of coherence; then each evaluation's device
     work on the card against the CPU, float32, batch 8 (``EVAL_TOL``: the
     subset means rtol 1e-4 with atol 1e-4·max|ref|, IWAE with an injected
     eps 1e-4·max(1, |ref|) for every subset × modality and the joint,
     ``_fit_lr_batch`` 2e-3·max(1, max|ref|), each classifier's
     probabilities |Δ| ≤ 1e-4, the det-z conditional samples rtol 1e-4 with
     atol 1e-4·max|ref| and their probabilities |Δ| ≤ 1e-4 where both sides'
     classifiers read the same input: a word-text token whose argmax flips
     at a near tie is counted, not compared).

Phase 9's numbers are printed as one JSON line ``{"epoch_training": ...}``,
phase 10's as ``{"cli_training": ...}``, phase 11's as
``{"char_and_serving": ...}``, phase 12's as ``{"evaluation": ...}``.
The last lines are a JSON object of the kernels (each with its launches on
its path, a replayed step's launches from phase 9's trace, error, time,
plain time, the least time the card could take for its bytes, operations
and exponentials, and the time of a single PyTorch call computing the same
function where one exists), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mopoe_mimic_tpu_torch import main as train_cli
from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.ops import _build, cuda_batchnorm, cuda_fusion, cuda_pointwise, cuda_texthead
from mopoe_mimic_tpu_torch.ops import fusion as F
from mopoe_mimic_tpu_torch.ops import pointwise as PW
from mopoe_mimic_tpu_torch.ops import texthead as TH
from mopoe_mimic_tpu_torch.data.device_store import DeviceStore
from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
from mopoe_mimic_tpu_torch.experiment import Experiment
from mopoe_mimic_tpu_torch.serve import InferenceSession
from mopoe_mimic_tpu_torch.train.autotune import autotune_batch_size, step_memory_bytes
from mopoe_mimic_tpu_torch.train.scan import WARMUP_STEPS, epoch_index_matrix, make_train_epoch
from mopoe_mimic_tpu_torch.train.state import create_train_state
from mopoe_mimic_tpu_torch.train.step import loss_terms, make_train_step
from mopoe_mimic_tpu_torch.utils.checkpoints import CheckpointManager
from mopoe_mimic_tpu_torch.utils.exceptions import DeviceOutOfMemory

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "flagship.json"
K1_SOURCE = "mopoe_mimic_tpu_torch/csrc/poe_subsets.cu"
K2_SOURCE = "mopoe_mimic_tpu_torch/csrc/texthead.cu"
K3_SOURCE = "mopoe_mimic_tpu_torch/csrc/pointwise.cu"
KERNELS = {  # name → (source, the TPU kernel it replaces)
    "poe_subsets_f32": (K1_SOURCE, "mopoe_mimic_tpu/ops/pallas_fusion.py:42"),
    "poe_subsets_bwd_f32": (K1_SOURCE, "mopoe_mimic_tpu/ops/pallas_fusion.py:86"),
    "texthead_fwd": (K2_SOURCE, "mopoe_mimic_tpu/ops/pallas_texthead.py:72"),
    "texthead_bwd_dh": (K2_SOURCE, "mopoe_mimic_tpu/ops/pallas_texthead.py:88"),
    "texthead_bwd_dw": (K2_SOURCE, "mopoe_mimic_tpu/ops/pallas_texthead.py:88"),
    "texthead_bwd_dw_finalize": (K2_SOURCE, "mopoe_mimic_tpu/ops/pallas_texthead.py:88"),
    "pointwise_fwd": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:81"),
    "pointwise_fwd_tc": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:81"),
    "pointwise_bwd_reduce": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:88"),
    "pointwise_bwd_reduce_tc": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:88"),
    "pointwise_bwd_finalize": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:88"),
    "pointwise_bwd_dx": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:119"),
    "pointwise_bwd_dx_tc": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:119"),
    # the fused op's batch statistics, which the JAX package leaves to XLA
    # outside its Pallas kernel, and bn1's running update
    "pointwise_stats": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:285"),
    "pointwise_stats_finalize": (K3_SOURCE, "mopoe_mimic_tpu/ops/pallas_pointwise.py:285"),
}
K3 = tuple(name for name, (source, _) in KERNELS.items() if source == K3_SOURCE)
K12 = tuple(name for name in KERNELS if name not in K3)  # the fused_text_head run's kernels
K3_CALLS_PER_STEP = 32  # residual blocks of a joint_elbo flagship step
K2_PER_STEP = {"texthead_fwd": 1, "texthead_bwd_dh": 1, "texthead_bwd_dw": 1,
               "texthead_bwd_dw_finalize": 1}  # launches per bf16 train step
# bfloat16 only: float32 dW has no row splits to finalize, and K3's
# tensor-core kernels take a bfloat16 W; float32 only: K3's CUDA-core
# forward and passes, which a bfloat16 call never reaches
BF16_ONLY = ("texthead_bwd_dw_finalize", "pointwise_fwd_tc", "pointwise_bwd_reduce_tc",
             "pointwise_bwd_dx_tc")
F32_ONLY = ("pointwise_fwd", "pointwise_bwd_reduce", "pointwise_bwd_dx")
K3_BF16 = tuple(name for name in K3 if name not in F32_ONLY)  # the bf16 step's K3 kernels
# the tensor-core kernels (bfloat16), by the name of their __global__ function
TENSOR_CORE_KERNELS = ("texthead_fwd_tc", "texthead_bwd_dh_tc", "texthead_bwd_dw_tc",
                       "pointwise_fwd_tc", "pointwise_bwd_reduce_tc", "pointwise_bwd_dx_tc")
NAMES = ("PA", "Lateral", "text")
FLAGSHIP_HEAD = (256, 128, 64, 3517)  # K2 at the flagship: (B, L, C, V)
TRAIN_WARMUP_STEPS = 300  # lr_warmup_steps of the training phase
SUBSETS = {"PA", "Lateral", "text", "Lateral_PA", "PA_text", "Lateral_text", "Lateral_PA_text"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# Published peaks of one H100 SXM at 700 W (NVIDIA's H100 datasheet):
# HBM bytes/s, and dense operations/s by operand type (bf16 on tensor cores,
# float32 on the CUDA cores); and the SFU's exponentials (ex2), 16 a clock
# on each of the 132 SMs (the Hopper white paper's SM), at the card's
# maximum SM clock (``sm_max_clock_hz``)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SMS = 132
EX2_PER_SM_CLOCK = 16


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@functools.lru_cache(maxsize=None)
def sm_max_clock_hz() -> float:
    """The card's maximum SM clock, read once from nvidia-smi."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return float(proc.stdout.split()[0]) * 1e6


def least_time(moved: int, ops: float, dtype: torch.dtype, exps: float = 0) -> dict:
    """The least time the card could take: the largest of ``moved`` bytes
    (each input read once, each output written once) over the HBM rate,
    ``ops`` operations over the peak for ``dtype``, and ``exps``
    exponentials over the SFUs' rate."""
    times = {"bytes": moved / HBM_BYTES_PER_S * 1e3,
             "operations": ops / PEAK_OPS_PER_S[dtype] * 1e3}
    if exps:
        times["exponentials"] = exps / (SMS * EX2_PER_SM_CLOCK * sm_max_clock_hz()) * 1e3
    bound_by = max(times, key=times.get)
    return {"bound_ms": times[bound_by], "bound_by": bound_by}


def card() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def ptxas_report() -> dict:
    """ptxas's registers, spill bytes and stack frame of every kernel
    instantiation of the build (its ``-Xptxas -v`` report), by mangled
    name."""
    found, current = {}, None
    for line in _build.build_log_path().read_text().splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            current = entry.group(1)
            found[current] = {}
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            found[current].update(stack_bytes=int(spill.group(1)),
                                  spill_store_bytes=int(spill.group(2)),
                                  spill_load_bytes=int(spill.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            found[current]["registers"] = int(regs.group(1))
    return found


def k1_resources(report: dict) -> dict:
    """Phase 2's evidence for K1: registers and spills of each instantiation
    of its kernels (forward and backward, power set and generic). Fails if
    one is missing from the report or spills."""
    mine = {name: info for name, info in report.items() if "poe_subsets" in name}
    for glob in (*K1_GLOBALS.values(), "poe_subsets_generic_f32_kernel",
                 "poe_subsets_generic_bwd_f32_kernel"):
        n = sum(glob in name for name in mine)
        check(n == (1 if "generic" in glob else 6), f"{glob}: {n} instantiations in the report")
    for name, info in sorted(mine.items()):
        check(info.get("spill_store_bytes") == 0 and info.get("spill_load_bytes") == 0,
              f"{name}: spills {info}")
        print(f"ptxas {name}: {info.get('registers')} registers, spills "
              f"{info.get('spill_store_bytes')} B stored / {info.get('spill_load_bytes')} B "
              f"loaded, stack {info.get('stack_bytes')} B")
    return mine


def kernel_resources(lib_path: str, report: dict = None) -> dict:
    """Phase 2's evidence for the tensor-core kernels: ptxas's registers,
    spill bytes and stack frame for each of their instantiations
    (``report``, else ``ptxas_report()``) and the count of tensor-core
    instructions (HMMA or HGMMA) in each one's SASS (``cuobjdump -sass`` of
    the built library). Fails if a kernel has none."""
    found = {name: dict(info) for name, info in (report or ptxas_report()).items()
             if any(k in name for k in TENSOR_CORE_KERNELS)}
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", lib_path], capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0, f"cuobjdump -sass failed: {proc.stderr.strip()[-2000:]}")
    current = None
    for line in proc.stdout.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = fn.group(1) if fn.group(1) in found else None
        elif current and re.search(r"\bHG?MMA\b", line):
            found[current]["tensor_core_instructions"] = (
                found[current].get("tensor_core_instructions", 0) + 1)
    by_kernel = {}
    for name in TENSOR_CORE_KERNELS:
        mine = {m: info for m, info in found.items() if name in m}
        check(bool(mine), f"{name}: not in the build's ptxas report")
        for mangled, info in mine.items():
            check(info.get("tensor_core_instructions", 0) > 0,
                  f"{mangled}: no HMMA/HGMMA instruction in its SASS")
            print(f"sass {mangled}: {info.get('tensor_core_instructions', 0)} HMMA/HGMMA, "
                  f"{info.get('registers')} registers, spills {info.get('spill_store_bytes')} "
                  f"B stored / {info.get('spill_load_bytes')} B loaded, stack "
                  f"{info.get('stack_bytes')} B")
        by_kernel[name] = mine
    return by_kernel


# ---------------------------------------------------------------------------
# K1 against its plain version
# ---------------------------------------------------------------------------

def cuda_ms(fn, calls: int = 100, warmup: int = 10) -> float:
    """Median device time of one call, CUDA events around each call
    (after a synchronize, so it includes the host's dispatch of the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# K1's cases: the experts as separate [B, D] tensors, as views of one wide
# tensor with a row stride other than D, and as a stacked [M, B, D] pair
K1_FORMS = ("separate", "strided", "stacked")
K1_BATCHES = (1, 5, 8, 32, 128, 256)
K1_DIMS = (64, 6)
K1_TIMED_BATCHES = (8, 128, 256)
K1_GLOBALS = {"poe_subsets_f32": "poe_subsets_f32_kernel",
              "poe_subsets_bwd_f32": "poe_subsets_bwd_f32_kernel"}


def k1_values(rng, m: int, b: int, d: int, device) -> tuple:
    """Seeded experts, stacked: mus, logvars [M, B, D] float32 on ``device``."""
    return tuple(torch.from_numpy(rng.normal(size=(m, b, d)).astype(np.float32)).to(device)
                 for _ in range(2))


def k1_experts(values: tuple, form: str, grad: bool = False) -> tuple:
    """The stacked experts ``values`` in ``form`` (K1_FORMS): (mus,
    logvars) as ``poe_subsets_cuda`` takes them, and the flat list of
    tensors whose gradients autograd is asked for (leaves, or views of a
    leaf, recording gradients where ``grad``)."""
    mus, lvs = values
    m, b, d = mus.shape
    if form == "stacked":
        pair = [x.clone().requires_grad_(grad) for x in values]
        return pair[0], pair[1], pair
    if form == "separate":
        experts = [x.clone().requires_grad_(grad) for x in (*mus, *lvs)]
    else:
        wide = torch.zeros((b, 2 * m * (d + 4)), device=mus.device)
        starts = [k * (d + 4) for k in range(2 * m)]
        for start, x in zip(starts, (*mus, *lvs)):
            wide[:, start:start + d] = x
        wide.requires_grad_(grad)
        experts = [wide[:, start:start + d] for start in starts]
    return experts[:m], experts[m:], experts


def k1_stacked_grads(grads, m: int) -> tuple:
    """Gradients as autograd gives them for ``k1_experts``' list: dmu, dlv
    [M, B, D]."""
    if len(grads) == 2:
        return grads[0], grads[1]
    return torch.stack(grads[:m]), torch.stack(grads[m:])


def k1_case(values, mask, prior: bool, form: str, up: tuple) -> dict:
    """One K1 case on the card: the forward without a gradient against the
    plain forward; the gradients through the kernels (the forward recording,
    then the backward kernel) against the closed-form plain backward and
    against autograd of the plain forward. Returns the largest |Δ| of each
    and whether the forward was bitwise equal."""
    m = values[0].shape[0]
    mus, lvs, _ = k1_experts(values, form)
    got = cuda_fusion.poe_subsets_cuda(mus, lvs, mask, prior_expert=prior)
    ref = F.poe_subsets(*values, mask, prior_expert=prior)
    g_mus, g_lvs, leaves = k1_experts(values, form, grad=True)
    grads = k1_stacked_grads(torch.autograd.grad(
        cuda_fusion.poe_subsets_cuda(g_mus, g_lvs, mask, prior_expert=prior), leaves, up), m)
    closed = F.poe_subsets_bwd(*values, *up, mask, prior_expert=prior)
    y = [x.clone().requires_grad_() for x in values]
    auto = torch.autograd.grad(F.poe_subsets(*y, mask, prior_expert=prior), y, up)
    torch.cuda.synchronize()
    tag = f"M={m} B={values[0].shape[1]} D={values[0].shape[2]} prior={prior} {form}"
    fwd = 0.0
    for g, r, what in zip(got, ref, ("mu", "logvar")):
        check(g.shape == r.shape, f"K1 {what} {tag}: shape {tuple(g.shape)} != {tuple(r.shape)}")
        err = (g - r).abs()
        check(bool((err <= 1e-6 * r.abs().clamp(min=1.0)).all()),
              f"K1 {what} {tag}: max |Δ| {err.max().item():.3e}")
        fwd = max(fwd, err.max().item())
    bwd = 0.0
    for ref_name, refs in (("plain", closed), ("autograd", auto)):
        for g, r, what in zip(grads, refs, ("dmu", "dlogvar")):
            err = (g - r).abs()
            check(bool((err <= 1e-5 * r.abs().clamp(min=1.0)).all()),
                  f"K1 bwd {what} vs {ref_name} {tag}: max |Δ| {err.max().item():.3e}")
            bwd = max(bwd, err.max().item())
    return {"fwd": fwd, "bwd": bwd, "bitwise": all(torch.equal(g, r) for g, r in zip(got, ref))}


def k1_generic_masks() -> list:
    """Masks that take the generic kernels: the power set of 3 in reverse
    and three of its rows out of order, the power set of 4 experts (more
    than the power-set kernels take) and of 2 in reverse."""
    three = F.subset_mask_matrix(NAMES)
    return [three[::-1], three[[6, 0, 3]], F.subset_mask_matrix(("a", "b", "c", "d")),
            F.subset_mask_matrix(NAMES[:2])[::-1]]


def k1_saved_hook_case(values, mask, form: str, up: tuple) -> float:
    """The backward kernel under a saved-tensor hook that keeps a host copy
    (as ``save_on_cpu`` does, which keeps CPU tensors as they are), with the
    forward's experts overwritten by NaN before the backward: it reads the
    experts that autograd unpacks, so its gradients still match the closed
    form at 1e-5·max(1, |ref|). Returns the largest |Δ|."""
    m = values[0].shape[0]
    mus, lvs, leaves = k1_experts(values, form, grad=True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: (x.device, x.to("cpu", copy=True)), lambda saved: saved[1].to(saved[0])):
        out = cuda_fusion.poe_subsets_cuda(mus, lvs, mask)
    for x in leaves:  # the same memory, the version counters untouched
        x.data.fill_(float("nan"))
    grads = k1_stacked_grads(torch.autograd.grad(out, leaves, up), m)
    worst = 0.0
    for g, r, what in zip(grads, F.poe_subsets_bwd(*values, *up, mask), ("dmu", "dlogvar")):
        err = (g - r).abs()
        check(bool((err <= 1e-5 * r.abs().clamp(min=1.0)).all()),
              f"K1 bwd {what} under a saved-tensor hook, M={m} {form}: "
              f"max |Δ| {err.max().item():.3e}")
        worst = max(worst, err.max().item())
    return worst


def k1_against_plain(device: torch.device) -> dict:
    """K1's forward and backward against the plain versions (``k1_case``):
    the power-set layouts at M ∈ {1, 2, 3}, every B of K1_BATCHES and D of
    K1_DIMS, prior both ways, the experts in each of K1_FORMS; then the
    generic kernels (``k1_generic_masks``) at B ∈ {5, 256}, D = 64; then
    the backward under a saved-tensor hook (``k1_saved_hook_case``) at
    M = 3, B = 8, D = 64 in each form. Forward |Δ| ≤ 1e-6·max(1, |ref|),
    backward 1e-5·max(1, |ref|)."""
    rng = np.random.default_rng(0)
    worst = {"fwd": 0.0, "bwd": 0.0}
    cases, bitwise = 0, 0
    powerset = [(F.subset_mask_matrix(NAMES[:m]), m, b, d, form)
                for m in (1, 2, 3) for b in K1_BATCHES for d in K1_DIMS for form in K1_FORMS]
    generic = [(mask, mask.shape[1], b, 64, form) for mask in k1_generic_masks()
               for b in (5, 256) for form in ("separate", "stacked")]
    for mask, m, b, d, form in powerset + generic:
        full = F.subset_mask_matrix(tuple(f"m{i}" for i in range(m)))
        check((cuda_fusion.kernel_layout(mask, m).masks is None)
              == (m <= 3 and np.array_equal(mask, full)), f"K1 layout of {mask.tolist()}")
        values = k1_values(rng, m, b, d, device)
        up = k1_values(rng, mask.shape[0], b, d, device)
        for prior in (False, True):
            got = k1_case(values, mask, prior, form, up)
            worst["fwd"] = max(worst["fwd"], got["fwd"])
            worst["bwd"] = max(worst["bwd"], got["bwd"])
            cases += 1
            bitwise += got["bitwise"]
    mask = F.subset_mask_matrix(NAMES)
    hooked = max(k1_saved_hook_case(k1_values(rng, 3, 8, 64, device), mask, form,
                                    k1_values(rng, 7, 8, 64, device)) for form in K1_FORMS)
    worst["bwd"] = max(worst["bwd"], hooked)
    print(f"K1 vs plain, {cases} cases (power set: M∈{{1,2,3}}, B∈{K1_BATCHES}, D∈{K1_DIMS}, "
          f"prior both ways, experts {', '.join(K1_FORMS)}; generic: "
          f"{len(k1_generic_masks())} masks, B∈{{5,256}}, D=64): forward max |Δ| "
          f"{worst['fwd']:.3e} (bound 1e-6·max(1,|ref|)), bitwise equal in {bitwise} of "
          f"{cases}; backward max |Δ| {worst['bwd']:.3e} vs the closed form and autograd of the "
          f"plain forward (bound 1e-5·max(1,|ref|)); under a saved-tensor hook with the "
          f"forward's experts overwritten {hooked:.3e}")
    return worst


def k1_device_us(device: torch.device, card_line: str) -> dict:
    """Device µs of K1's power-set kernels (M = 3, D = 64, no prior, the
    experts separate as the model passes them) at each B of
    K1_TIMED_BATCHES, from the profiler (``device_us``: mean of 5 calls;
    CUDA events where no session recorded the kernel, named):
    {B: (fwd µs, bwd µs)}."""
    mask = F.subset_mask_matrix(NAMES)
    rng = np.random.default_rng(2)
    table, by_events = {}, []
    for b in K1_TIMED_BATCHES:
        mus, lvs, _ = k1_experts(k1_values(rng, 3, b, 64, device), "separate")
        dmu_s, dlv_s = k1_values(rng, 7, b, 64, device)
        times = []
        for name, fn in (
                ("poe_subsets_f32", lambda: cuda_fusion.poe_subsets_cuda(mus, lvs, mask)),
                ("poe_subsets_bwd_f32", lambda: cuda_fusion.poe_subsets_bwd_cuda(
                    mus, lvs, dmu_s, dlv_s, mask))):
            t, how = device_us(fn, K1_GLOBALS[name])
            times.append(t)
            if how != "profiled":
                by_events.append((name, b))
        table[b] = tuple(times)
    print("K1 device µs fwd / bwd, M=3 D=64, 1 element a thread, 128 threads a block: "
          + ", ".join(f"B={b} {f:.2f} / {w:.2f}" for b, (f, w) in table.items())
          + f" (profiled, mean of 5) [{card_line}]"
          + (f"; by CUDA events, not profiled: {by_events}" if by_events else ""))
    return table


def k1_times(device: torch.device, card_line: str) -> dict:
    """K1's kernels at the module's choice (M = 3, D = 64, no prior, the
    experts separate) against the plain versions at each B of
    K1_TIMED_BATCHES, CUDA-event medians of 100 calls (host dispatch
    included): the forward without a gradient, and the backward kernel
    alone against the closed-form plain backward. {name: {B: (kernel ms,
    plain ms)}}."""
    mask = F.subset_mask_matrix(NAMES)
    rng = np.random.default_rng(3)
    times = {name: {} for name in K1_GLOBALS}
    for b in K1_TIMED_BATCHES:
        values = k1_values(rng, 3, b, 64, device)
        mus, lvs, _ = k1_experts(values, "separate")
        up = k1_values(rng, 7, b, 64, device)
        times["poe_subsets_f32"][b] = (
            cuda_ms(lambda: cuda_fusion.poe_subsets_cuda(mus, lvs, mask)),
            cuda_ms(lambda: F.poe_subsets(mus, lvs, mask)))
        times["poe_subsets_bwd_f32"][b] = (
            cuda_ms(lambda: cuda_fusion.poe_subsets_bwd_cuda(mus, lvs, *up, mask)),
            cuda_ms(lambda: F.poe_subsets_bwd(mus, lvs, *up, mask)))
    for name, by_b in times.items():
        print(f"K1 {name} time M=3 D=64: "
              + ", ".join(f"B={b} kernel {k * 1e3:.2f} us, plain {p * 1e3:.2f} us"
                          for b, (k, p) in by_b.items())
              + f" (median of 100 calls, CUDA events) [{card_line}]")
    return times


def k1_host_us(device: torch.device, calls: int = 1000) -> dict:
    """The host's µs per call of each piece of one ``poe_subsets_cuda`` call
    at M = 3, B = 128, D = 64 (the experts separate, as the model passes
    them), and of the whole call: without and with a gradient to record,
    on a stacked pair, and after stacking the experts as the model did
    before it read them in place. ``time.perf_counter`` over ``calls``
    back-to-back calls of each (after 10 more), ending in a synchronize."""
    mask = F.subset_mask_matrix(NAMES)
    stacked = k1_values(np.random.default_rng(4), 3, 128, 64, device)
    mus, lvs, _ = k1_experts(stacked, "separate")
    g_mus, g_lvs, _ = k1_experts(stacked, "separate", grad=True)
    call = cuda_fusion._call(mus, lvs, mask, False)
    mu_out, lv_out = (torch.empty((7, 128, 64), device=device) for _ in range(2))
    lib = _build.load_library()
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    args = (call.experts, mu_out.data_ptr(), lv_out.data_ptr(), 3, 128, 64, None, 0, 0.0,
            stream)

    def enter_device():
        with torch.cuda.device(device):
            pass

    pieces = {
        "checks + Experts": lambda: cuda_fusion._sequence_pointers(mus, lvs),
        "kernel_layout (cached)": lambda: cuda_fusion.kernel_layout(mask, 3),
        "torch.empty": lambda: torch.empty((7, 128, 64), device=device),
        "torch.cuda.device": enter_device,
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw stream (the launch's)": lambda: torch._C._cuda_getCurrentRawStream(
            torch._C._cuda_getDevice()),
        "ctypes call": lambda: lib.poe_subsets_f32(*args),
        "Function.apply": lambda: cuda_fusion._PoeSubsets.apply(call, *mus, *lvs),
        "poe_subsets_cuda": lambda: cuda_fusion.poe_subsets_cuda(mus, lvs, mask),
        "poe_subsets_cuda (grad)": lambda: cuda_fusion.poe_subsets_cuda(g_mus, g_lvs, mask),
        "poe_subsets_cuda (stacked pair)": lambda: cuda_fusion.poe_subsets_cuda(*stacked, mask),
        "torch.stack x2 + poe_subsets_cuda (stacked pair)": lambda: cuda_fusion.poe_subsets_cuda(
            torch.stack(mus), torch.stack(lvs), mask),
    }
    out = {}
    for name, fn in pieces.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    print("K1 host µs per call, M=3 B=128 D=64, experts separate (perf_counter over 1000 "
          "calls): " + ", ".join(f"{n} {t:.2f}" for n, t in out.items()))
    return out


def k1_entries(device: torch.device, card_line: str) -> dict:
    """Phase 3's K1: the checks, the device times, the times and the
    host's µs; the kernels line's entries (time, plain time and bound at
    B = 256, the flagship's batch; the device µs and the CUDA-event times
    at each B beside them)."""
    worst = k1_against_plain(device)
    device_times = k1_device_us(device, card_line)
    times = k1_times(device, card_line)
    host = k1_host_us(device)
    mask = F.subset_mask_matrix(NAMES)
    n_sub, members = mask.shape[0], int(np.asarray(mask).sum())
    b, m, d = 256, 3, 64
    # per (b, d): M precisions (exp, add, divide), per subset the member
    # sums of T and mu·T, a divide and a log; the backward recomputes them
    # and does about as many again
    ops = b * d * (3 * m + 2 * members + 3 * n_sub)
    fwd_bytes = (2 * m + 2 * n_sub) * b * d * 4
    bwd_bytes = (2 * m + 2 * n_sub + 2 * m) * b * d * 4
    out = {}
    for name, err, moved, n_ops in (("poe_subsets_f32", worst["fwd"], fwd_bytes, ops),
                                    ("poe_subsets_bwd_f32", worst["bwd"], bwd_bytes, 2 * ops)):
        k_ms, p_ms = times[name][b]
        col = 0 if name == "poe_subsets_f32" else 1
        out[name] = {
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            **least_time(moved, n_ops, torch.float32), "library_ms": None,
            "device_us": {bb: device_times[bb][col] for bb in K1_TIMED_BATCHES},
            "ms_by_batch": {bb: times[name][bb][0] for bb in K1_TIMED_BATCHES}}
    out["poe_subsets_f32"]["host_us"] = host
    return out


def k2_case(device, B, L, C, V, dtype, seed):
    """Seeded K2 inputs as the kernels take them: h [R, C], kernel [C, V]
    in ``dtype``, bias [V] f32, targets [R] int32 (the first and last
    rows hitting token 0 and V − 1), upstream gradient g [R] f32."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(device, dt)  # noqa: E731
    targets = rng.integers(0, V, size=(B * L,))
    targets[0], targets[-1] = 0, V - 1
    return (t(rng.normal(size=(B * L, C)), dtype), t(rng.normal(size=(C, V)) * 0.1, dtype),
            t(rng.normal(size=(V,)) * 0.1), t(targets, torch.int32),
            t(rng.normal(size=(B * L,))))


K2_CASES = (  # (B, L, C, V), dtype
    ((3, 17, 10, 37), torch.float32), ((4, 128, 64, 3517), torch.float32),
    (FLAGSHIP_HEAD, torch.float32),
    ((3, 17, 10, 37), torch.bfloat16),    # ragged rows, vocabulary and channels
    ((3, 32, 24, 301), torch.bfloat16),
    ((2, 64, 128, 300), torch.bfloat16),  # C = 128: the wide instantiations
    (FLAGSHIP_HEAD, torch.bfloat16),
)


def k2_run(h, k, b, t, g):
    """K2's kernels: (lp, lse) forward, then dh, dW, db from that lse."""
    lp, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    dh = cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g)
    return (lp, lse, dh, *cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g))


def k2_against_plain(device: torch.device, card_line: str) -> dict:
    """K2's kernels against the plain pair on the same inputs (K2_CASES),
    each case run twice and required bitwise equal; then each kernel timed
    against its plain version at the flagship, and the fused head against
    the unfused composition."""
    def close(got, ref, rtol, atol, what):
        err = (got.double() - ref.double()).abs()
        check(bool((err <= atol + rtol * ref.double().abs()).all()),
              f"K2 {what}: max |Δ| {err.max().item():.3e} (max|ref| {ref.abs().max().item():.3e})")
        return err.max().item()

    def within(got, ref, frac, what):  # |Δ| ≤ frac·max(1, |ref|)
        err = (got.double() - ref.double()).abs()
        check(bool((err <= frac * ref.double().abs().clamp(min=1.0)).all()),
              f"K2 {what}: max |Δ| {err.max().item():.3e}")
        return err.max().item()

    worst = dict.fromkeys(("texthead_fwd", "texthead_bwd_dh", "texthead_bwd_dw"), 0.0)
    for i, (shape, dtype) in enumerate(K2_CASES):
        h, k, b, t, g = k2_case(device, *shape, dtype, seed=20 + i)
        got = k2_run(h, k, b, t, g)
        again = k2_run(h, k, b, t, g)
        lp, lse, dh, dw, db = got
        # float32: the plain pair accumulated in float64. At the flagship a
        # float32 GEMM over R = 32768 rows is itself ~4e-5 off in dW, more
        # than the kernel (which sums row chunks with Kahan addition)
        acc = torch.float64 if dtype == torch.float32 else None
        r_lp, r_lse = TH.texthead_fwd_plain(h, k, b, t, acc)
        r_dh, r_dw, r_db = TH.texthead_bwd_plain(h, k, b, t, r_lse, g, acc)
        torch.cuda.synchronize()
        tag = f"{shape} {str(dtype).split('.')[-1]}"
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"K2 {tag}: two runs on the same inputs differ")
        if dtype == torch.float32:
            fwd = [close(x, r, 1e-5, 1e-5, f"{n} {tag}") for x, r, n in
                   ((lp, r_lp, "lp"), (lse, r_lse, "lse"))]
            grads = [close(x, r, 1e-4, 1e-5, f"{n} {tag}") for x, r, n in
                     ((dh, r_dh, "dh"), (dw, r_dw, "dW"), (db, r_db, "db"))]
        else:  # bf16 × bf16 products are exact in float32: the sums' order and ex2 differ
            fwd = [within(x, r, 1e-5, f"{n} {tag}") for x, r, n in
                   ((lp, r_lp, "lp"), (lse, r_lse, "lse"))]
            grads = [close(x, r, 0.0, 2e-2 * r.float().abs().max().item(), f"{n} {tag}")
                     for x, r, n in ((dh, r_dh, "dh"), (dw, r_dw, "dW"), (db, r_db, "db"))]
        worst["texthead_fwd"] = max(worst["texthead_fwd"], *fwd)
        worst["texthead_bwd_dh"] = max(worst["texthead_bwd_dh"], grads[0])
        worst["texthead_bwd_dw"] = max(worst["texthead_bwd_dw"], grads[1], grads[2])
        print(f"K2 vs plain {tag}: max |Δ| lp/lse {max(fwd):.3e}, dh {grads[0]:.3e}, "
              f"dW {grads[1]:.3e}, db {grads[2]:.3e}; two runs bitwise equal")
        del got, again

    h, k, b, t, g = k2_case(device, *FLAGSHIP_HEAD, torch.bfloat16, seed=30)
    _, lse = cuda_texthead.texthead_fwd_cuda(h, k, b, t)
    parts = cuda_texthead.texthead_bwd_dw_partials_cuda(h, k, b, t, lse, g)
    dw, db = cuda_texthead.texthead_bwd_dw_finalize_cuda(*parts)

    def plain_dw():
        dlog = TH.texthead_dlog_plain(h, k, b, t, lse, g)
        return h.float().t() @ dlog, dlog.sum(0)

    # texthead_bwd_dw is one function (dW, db from h, W, b, t, lse, g), run
    # as two kernels in bfloat16: timed and bounded as one, partials and
    # finalize together; the finalize also alone
    timed = {
        "texthead_fwd": (lambda: cuda_texthead.texthead_fwd_cuda(h, k, b, t),
                         lambda: TH.texthead_fwd_plain(h, k, b, t)),
        "texthead_bwd_dh": (lambda: cuda_texthead.texthead_bwd_dh_cuda(h, k, b, t, lse, g),
                            lambda: (TH.texthead_dlog_plain(h, k, b, t, lse, g)
                                     @ k.float().t()).to(h.dtype)),
        "texthead_bwd_dw": (lambda: cuda_texthead.texthead_bwd_dw_cuda(h, k, b, t, lse, g),
                            plain_dw),
        "texthead_bwd_dw_finalize": (
            lambda: cuda_texthead.texthead_bwd_dw_finalize_cuda(*parts),
            lambda: (parts[0].sum(0), parts[1].sum(0))),
    }
    # the products: logits (2·R·C·V) in the forward; logits again and one
    # more product in each backward kernel; bf16 operands on tensor cores;
    # and one exponential per logit in each. The partials are scratch of
    # this design and count in no bound: the finalize's own bound is the
    # writing of dW and db
    R, C, V = h.shape[0], h.shape[1], k.shape[1]
    product, exps = 2 * R * C * V, R * V
    bounds = {
        "texthead_fwd": least_time(nbytes(h, k, b, t) + 2 * R * 4, product, torch.bfloat16,
                                   exps),
        "texthead_bwd_dh": least_time(nbytes(h, k, b, t, lse, g, h), 2 * product,
                                      torch.bfloat16, exps),
        "texthead_bwd_dw": least_time(nbytes(h, k, b, t, lse, g, dw, db), 2 * product,
                                      torch.bfloat16, exps),
        "texthead_bwd_dw_finalize": least_time(nbytes(dw, db), 0, torch.float32),
    }
    out = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        k_ms = cuda_ms(kernel_fn, calls=20, warmup=3)
        p_ms = cuda_ms(plain_fn, calls=20, warmup=3)
        out[name] = {"max_abs_err": worst.get(name, worst["texthead_bwd_dw"]), "ms": k_ms,
                     "plain_ms": p_ms, **bounds[name], "library_ms": None}
        print(f"K2 {name} time (B,L,C,V)={FLAGSHIP_HEAD} bf16: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms, bound {bounds[name]['bound_ms']:.4g} ms "
              f"({bounds[name]['bound_by']}) (median of 20 calls, CUDA events) [{card_line}]")
    partials_ms = cuda_ms(
        lambda: cuda_texthead.texthead_bwd_dw_partials_cuda(h, k, b, t, lse, g),
        calls=20, warmup=3)
    out["texthead_bwd_dw"]["partials_ms"] = partials_ms
    out["texthead_bwd_dw"]["splits"] = parts[0].shape[0]
    print(f"K2 texthead_bwd_dw's partials kernel alone: {partials_ms:.4f} ms "
          f"({parts[0].shape[0]} row splits; median of 20 calls, CUDA events)")
    head = head_against_unfused(h, k, b, t, g)
    out["texthead_fwd"]["head_ms"] = head
    print(f"K2 head (B,L,C,V)={FLAGSHIP_HEAD} bf16: fused (K2's kernels) fwd "
          f"{head['fused_fwd']:.4f} ms, fwd+bwd {head['fused_fwd_bwd']:.4f} ms; unfused "
          f"composition (autocast conv_out → log_softmax → gather, PyTorch calls) fwd "
          f"{head['unfused_fwd']:.4f} ms, fwd+bwd {head['unfused_fwd_bwd']:.4f} ms "
          f"(median of 20 calls, CUDA events) [{card_line}]")
    return out


def head_against_unfused(h, k, b, t, g) -> dict:
    """The text head as the model runs it, on the same h: fused (K2, through
    ``fused_text_logprob``) and unfused (the decoder's ``conv_out``, a 1×1
    Conv1d, under bf16 autocast, then ``log_softmax`` in float32 and the
    target's entry: ``models/text_networks.py`` and ``train/losses.py``),
    forward and forward + backward into h, W and b."""
    B, L = FLAGSHIP_HEAD[:2]
    C, V = k.shape
    conv = torch.nn.Conv1d(C, V, 1).to(h.device)
    with torch.no_grad():
        conv.weight.copy_(k.float().t().unsqueeze(-1))
        conv.bias.copy_(b)
    feats = h.reshape(B, L, C).detach().requires_grad_()  # [B, L, C] as the prehead gives it
    kernel = conv.weight[:, :, 0].t().detach().requires_grad_()
    bias = b.detach().requires_grad_()
    targets, w = t.reshape(B, L), g.reshape(B, L)

    def fused():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return TH.fused_text_logprob(feats, kernel, bias, targets)

    def unfused():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            logits = conv(feats.transpose(1, 2)).transpose(1, 2)  # [B, L, V]
        logp = torch.log_softmax(logits.float(), dim=-1)
        return torch.gather(logp, -1, targets.long().unsqueeze(-1)).squeeze(-1)

    times = {}
    for name, fn, leaves in (("fused", fused, [feats, kernel, bias]),
                             ("unfused", unfused, [feats, *conv.parameters()])):
        with torch.no_grad():
            times[f"{name}_fwd"] = cuda_ms(fn, calls=20, warmup=3)
        times[f"{name}_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad((fn() * w).sum(), leaves),
                                           calls=20, warmup=3)
    return times


# (B, C, Co, spatial, conv bias, the float32-BN flagship feeds bfloat16 x):
# blocks of the flagship step. The bf16 check runs every shape with bfloat16
# x (the blocks after a network's first under bn_compute_dtype="compute"),
# and with float32 x too where the last field is False
K3_CASES = (
    (3, 64, 64, (5, 5), True, True),        # small, odd rows
    (256, 64, 64, (64, 64), False, True),   # image encoder resblock_1 on the stem's bf16 output
    (256, 320, 320, (1,), True, False),     # the decoders' first block, S = 1
    (256, 320, 320, (4, 4), False, False),  # image encoder resblock_5
    (256, 256, 256, (64,), True, False),    # text decoder resblock_6 (1-D transpose)
)
K3_TIMED = (1, 3)  # the largest block and a C = 320 block


@functools.lru_cache(maxsize=None)
def k3_cases() -> tuple:
    """K3_CASES and the char networks' largest 1-D residual block at the
    flagship's widths (``char_block_shape``: C 64 at length 512, the char
    encoder's resblock_1 on the stem's bfloat16 output), batch 256, with
    its conv bias."""
    C, S = char_block_shape(MopoeConfig.from_json(str(FLAGSHIP)))
    return K3_CASES + ((256, C, C, (S,), True, True),)


def k3_case(device, B, C, Co, spatial, bias, transpose, x_dtype, w_dtype, seed):
    """Seeded K3 inputs as a block hands them to the kernels: x3 [B, C, S],
    gamma, beta, its batch statistics (mean, inv), W [C, Co] taken from a
    conv1 weight of the given layout (non-symmetric), cb, and dy [B, Co, S]."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    S = math.prod(spatial)
    x3 = (1.3 * rn(B, C, S) + 0.2).to(x_dtype)
    mean, var = PW.batch_stats(x3)
    weight = rn(*((C, Co) if transpose else (Co, C)), *([1] * len(spatial))) / math.sqrt(C)
    w = PW.conv1x1_matrix(weight, transpose).to(w_dtype).contiguous()
    cb = 0.1 * rn(Co) if bias else torch.zeros(Co, device=device)
    return (x3, 1.0 + 0.2 * rn(C), 0.1 * rn(C), mean, PW.inv_std(var, 1e-5), w, cb,
            rn(B, Co, S).to(w_dtype))


def k3_bounds(x3, w, dy) -> dict:
    """least_time of K3's kernels on a block's inputs x3 [B, C, S], W
    [C, Co] and dy [B, Co, S]: each input of the function read once (the
    four per-channel statistics and the conv bias in float32), each output
    written once (y in W's dtype, dx in x's, dW, dcb, dγ, dβ in float32);
    the products at the peak of W's dtype. The partials of pass A and of
    the statistics are scratch of this design, not work of the function:
    a finalize's share of its function's bound is the writing of the
    outputs. The float32 and tensor-core kernels of one function share its
    bound."""
    B, C, S = x3.shape
    Co = w.shape[1]
    R, stats, grads = B * S, 4 * C * 4, (C * Co + Co + 2 * C) * 4
    product = 2 * R * C * Co
    fwd = least_time(nbytes(x3, w) + Co * 4 + stats + R * Co * w.element_size(), product, w.dtype)
    pass_a = least_time(nbytes(x3, w, dy) + grads + stats, 2 * product, w.dtype)
    dx = least_time(2 * nbytes(x3) + nbytes(w, dy) + 2 * C * 4 + stats, product, w.dtype)
    return {
        "pointwise_fwd": fwd, "pointwise_fwd_tc": fwd,
        "pointwise_bwd_reduce": pass_a, "pointwise_bwd_reduce_tc": pass_a,
        "pointwise_bwd_finalize": least_time(grads, 0, torch.float32),
        "pointwise_bwd_dx": dx, "pointwise_bwd_dx_tc": dx, **k3_stats_bounds(x3),
    }


def k3_stats_bounds(x3) -> dict:
    """least_time of the statistics (``pointwise_stats`` + its finalize, one
    function) on x3 [B, C, S]: x read once; mean, var and inv written; bn1's
    two running buffers read and written; four float32 operations an
    element (x − pivot, its sum, its square's FMA). The finalize's share is
    the outputs' bytes."""
    B, C, S = x3.shape
    out = (3 * C + 2 * 2 * C) * 4
    return {"pointwise_stats": least_time(nbytes(x3) + out, 4 * B * S * C, torch.float32),
            "pointwise_stats_finalize": least_time(out, 0, torch.float32)}


def k3_names(w) -> dict:
    """The kernels a call with this W launches: function → kernel name."""
    tc = w.dtype == torch.bfloat16
    return {"fwd": "pointwise_fwd_tc" if tc else "pointwise_fwd",
            "pass_a": "pointwise_bwd_reduce_tc" if tc else "pointwise_bwd_reduce",
            "finalize": "pointwise_bwd_finalize",
            "dx": "pointwise_bwd_dx_tc" if tc else "pointwise_bwd_dx",
            "stats": "pointwise_stats", "stats_finalize": "pointwise_stats_finalize"}


def k3_step_bounds(run: dict) -> dict:
    """Σ over one train step of K3's bounds (``k3_bounds`` on the inputs
    each launch is given), by the kernel each launch went to, from one more
    step of ``run`` with the four launchers wrapped; the launches counted;
    and the blocks' shapes: {(B, C, S, Co, x dtype): blocks of the step}."""
    totals, calls, shapes = {}, {}, {}
    originals = {n: getattr(cuda_pointwise, n) for n in
                 ("pointwise_fwd_cuda", "pointwise_bwd_reduce_cuda", "pointwise_bwd_dx_cuda",
                  "pointwise_stats_cuda")}

    def add(bounds, kernels):
        for name in kernels:
            totals[name] = totals.get(name, 0.0) + bounds[name]["bound_ms"]
            calls[name] = calls.get(name, 0) + 1

    def wrap(fn_name, functions):
        def recorded(x3, gamma, beta, mean, inv, w, *rest):
            out = originals[fn_name](x3, gamma, beta, mean, inv, w, *rest)
            dy = rest[0] if fn_name != "pointwise_fwd_cuda" else out
            if fn_name == "pointwise_fwd_cuda":
                key = (*x3.shape, w.shape[1], x3.dtype)
                shapes[key] = shapes.get(key, 0) + 1
            names = k3_names(w)
            add(k3_bounds(x3, w, dy), [names[f] for f in functions])
            return out
        return recorded

    def stats_recorded(x3, eps, running=None):
        out = originals["pointwise_stats_cuda"](x3, eps, running)
        bounds = k3_stats_bounds(x3)
        add(bounds, bounds)
        return out

    try:
        cuda_pointwise.pointwise_fwd_cuda = wrap("pointwise_fwd_cuda", ("fwd",))
        cuda_pointwise.pointwise_bwd_reduce_cuda = wrap("pointwise_bwd_reduce_cuda",
                                                        ("pass_a", "finalize"))
        cuda_pointwise.pointwise_bwd_dx_cuda = wrap("pointwise_bwd_dx_cuda", ("dx",))
        cuda_pointwise.pointwise_stats_cuda = stats_recorded
        run["step"](run["state"], run["batch"])
        torch.cuda.synchronize()
    finally:
        for fn_name, fn in originals.items():
            setattr(cuda_pointwise, fn_name, fn)
    check(set(calls) == set(K3_BF16) and all(n == K3_CALLS_PER_STEP for n in calls.values()),
          f"K3 bound totals: launches {calls}, not {K3_CALLS_PER_STEP} of each of {K3_BF16}")
    return totals, shapes


def device_us_by_kernel(fn, calls: int = 5, expect=(), attempts: int = 6) -> dict:
    """Device µs per call of ``fn`` by kernel (the __global__ function's
    name), from ``torch.profiler`` over ``calls`` calls: each kernel's mean
    time a launch times its launches a call. On an H100 the profiler now and
    then records none of a session's kernels, several sessions in a row, or
    only some of their launches: sessions are taken until every kernel of
    ``expect`` has a session that recorded all its launches (or a first
    session recorded anything, without ``expect``), up to ``attempts``. Each
    kernel's time comes from the first session that recorded all its
    launches, else from the last that recorded some (the mean a launch
    standing for the dropped ones); a kernel no session recorded is
    missing from the result."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    whole, partial = {}, {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total, launches = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = kernel_name(e.name)
                total[name] = total.get(name, 0.0) + e.time_range.end - e.time_range.start
                launches[name] = launches.get(name, 0) + 1
        for name, t in total.items():
            if launches[name] % calls == 0:
                whole.setdefault(name, t / calls)
            else:
                partial[name] = t / launches[name] * max(1, round(launches[name] / calls))
        if (all(name in whole for name in expect) if expect else whole or partial):
            break
    return {**partial, **whole}


def device_us(fn, name: str = None) -> tuple:
    """(device µs per call of ``fn``, how it was taken): the profiled time
    of kernel ``name`` (all of ``fn``'s device ops without a name), or, where
    no profiler session recorded it, the median of 20 calls timed with CUDA
    events (``cuda_ms``: the host's dispatch of each call included, so an
    upper bound on the device time)."""
    times = device_us_by_kernel(fn, expect=(name,) if name else ())
    t = times.get(name) if name else sum(times.values())
    if t:
        return t, "profiled"
    return cuda_ms(fn, calls=20, warmup=2) * 1e3, "CUDA events"


def plain_stats(x3, eps, running):
    """The statistics as the fused op took them before ``pointwise_stats``
    (and still does on the CPU): ``batch_stats``, ``inv_std`` and
    ``update_running_stats``, eager PyTorch calls."""
    mean, var = PW.batch_stats(x3)
    inv = PW.inv_std(var, eps)
    PW.update_running_stats(*running, mean, var, x3.shape[0] * x3.shape[2])
    return mean, var, inv


def running_buffers(C: int, device, seed: int):
    """bn1's running buffers, seeded: (running_mean, running_var, momentum 0.1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (0.1 * torch.randn(C, generator=gen, device=device),
            0.5 + torch.rand(C, generator=gen, device=device), 0.1)


def k3_block_profile(shapes: dict, device, card_line: str) -> dict:
    """Device time of K3's bfloat16 kernels at each block shape of the
    fused step (``device_us``: each kernel through its own wrapper, the mean
    of 5 calls on seeded inputs of the shape, ``k3_case``), beside the
    shape's bounds, and of the statistics as the plain path takes them
    (``plain_stats``, every device op of it): {kernel: Σ over the step's
    blocks (µs)}, one line printed per shape, naming any time that the
    profiler did not record and CUDA events took instead."""
    step = {}
    for (B, C, S, Co, x_dtype), blocks in sorted(shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1]
                                                 * kv[0][2]):
        x3, g, b, m, inv, w, cb, dy = k3_case(device, B, C, Co, (S,), False, False, x_dtype,
                                              torch.bfloat16, seed=70)
        running = running_buffers(C, device, seed=71)
        per = cuda_pointwise.stats_chunks(B, C, S, x3.element_size())[0]
        part = cuda_pointwise.pointwise_stats_partials_cuda(x3)
        parts = cuda_pointwise.pointwise_bwd_partials_cuda(x3, g, b, m, inv, w, dy)
        dg, db = cuda_pointwise.pointwise_bwd_finalize_cuda(*parts)[2:]
        kernels = {
            "pointwise_stats": ("pointwise_stats_kernel",
                                lambda: cuda_pointwise.pointwise_stats_partials_cuda(x3)),
            "pointwise_stats_finalize": (
                "pointwise_stats_finalize_kernel",
                lambda: cuda_pointwise.pointwise_stats_finalize_cuda(part, B, S, per, 1e-5,
                                                                     running)),
            "pointwise_fwd_tc": ("pointwise_fwd_tc", lambda: cuda_pointwise.pointwise_fwd_cuda(
                x3, g, b, m, inv, w, cb)),
            "pointwise_bwd_reduce_tc": (
                "pointwise_bwd_reduce_tc",
                lambda: cuda_pointwise.pointwise_bwd_partials_cuda(x3, g, b, m, inv, w, dy)),
            "pointwise_bwd_finalize": ("pointwise_bwd_finalize_kernel",
                                       lambda: cuda_pointwise.pointwise_bwd_finalize_cuda(*parts)),
            "pointwise_bwd_dx_tc": (
                "pointwise_bwd_dx_tc",
                lambda: cuda_pointwise.pointwise_bwd_dx_cuda(x3, g, b, m, inv, w, dy, dg, db))}
        got, by_events = {}, []
        for k, (name, fn) in kernels.items():
            got[k], how = device_us(fn, name)
            if how != "profiled":
                by_events.append(k)
        got["plain_stats"], how = device_us(lambda: plain_stats(x3, 1e-5, running))
        if how != "profiled":
            by_events.append("plain_stats")
        check(all(t > 0 for t in got.values()), f"K3 profile {(B, C, S)}: a kernel took no "
                                                f"device time: {got}")
        for k, t in got.items():
            step[k] = step.get(k, 0.0) + t * blocks
        bounds = k3_bounds(x3, w, dy)
        chunks = cuda_pointwise.reduce_tc_chunks(B * S, C, Co, x3.element_size())[1]
        print(f"K3 block (B,C,S)=({B}, {C}, {S}) x {str(x_dtype)[6:]} ×{blocks} a step, device "
              f"µs (profiled, mean of 5): statistics {got['pointwise_stats']:.1f} + finalize "
              f"{got['pointwise_stats_finalize']:.1f} (bound "
              f"{bounds['pointwise_stats']['bound_ms'] * 1e3:.1f}; plain "
              f"{got['plain_stats']:.1f}), pointwise_fwd_tc {got['pointwise_fwd_tc']:.1f} (bound "
              f"{bounds['pointwise_fwd_tc']['bound_ms'] * 1e3:.1f}), pass A "
              f"{got['pointwise_bwd_reduce_tc']:.1f} + finalize "
              f"{got['pointwise_bwd_finalize']:.1f} (bound "
              f"{bounds['pointwise_bwd_reduce_tc']['bound_ms'] * 1e3:.1f}; {chunks} chunks), "
              f"pointwise_bwd_dx_tc {got['pointwise_bwd_dx_tc']:.1f} (bound "
              f"{bounds['pointwise_bwd_dx_tc']['bound_ms'] * 1e3:.1f}; rows "
              f"{cuda_pointwise.dx_tc_rows(B * S, C)})"
              + (f"; by CUDA events, not profiled: {', '.join(by_events)}" if by_events else ""))
        del x3, g, b, m, inv, w, cb, dy, dg, db, running, part, parts
    print("K3 per fused_pointwise step by block shape, Σ device µs: "
          + ", ".join(f"{k} {t:.1f}" for k, t in step.items()) + f" [{card_line}]")
    return step


def k3_run(args):
    """K3's kernels (forward, pass A, pass B) on ``args``."""
    x3, g, b, m, inv, w, cb, dy = args
    y = cuda_pointwise.pointwise_fwd_cuda(x3, g, b, m, inv, w, cb)
    dw, dcb, dg, db = cuda_pointwise.pointwise_bwd_reduce_cuda(x3, g, b, m, inv, w, dy)
    return y, cuda_pointwise.pointwise_bwd_dx_cuda(x3, g, b, m, inv, w, dy, dg, db), dw, dcb, dg, db


def k3_plain(args, acc=None):
    x3, g, b, m, inv, w, cb, dy = args
    y = PW.pointwise_fwd_plain(x3, g, b, m, inv, w, cb, acc)
    dw, dcb, dg, db = PW.pointwise_bwd_reduce_plain(x3, g, b, m, inv, w, dy, acc)
    return y, PW.pointwise_bwd_dx_plain(x3, g, b, m, inv, w, dy, dg, db, acc), dw, dcb, dg, db


def k3_against_plain(device: torch.device) -> dict:
    """K3's kernels against the plain versions at the flagship's block
    shapes, both conv1 layouts: float32 (the CUDA-core kernels; plain
    accumulated in float64) and bfloat16 (the tensor-core forward and
    passes; each case run twice, every output bitwise equal). Then timed:
    the bfloat16 kernels at K3_TIMED against the plain versions, with pass
    A's scratch bytes beside the bytes of its inputs, and the fused op
    against the unfused cuDNN composition; the float32 forward and passes
    at the largest block. The statistics: ``k3_stats_against_plain``."""
    def close(got, ref, rtol, atol_frac, what):
        ref = ref.double()
        err = (got.double() - ref).abs()
        atol = atol_frac * ref.abs().max().item()
        check(bool((err <= atol + rtol * ref.abs()).all()),
              f"K3 {what}: max |Δ| {err.max().item():.3e} (max|ref| {ref.abs().max().item():.3e})")
        return err.max().item()

    names = ("y", "dx", "dW", "dcb", "dgamma", "dbeta")
    worst = dict.fromkeys(K3, 0.0)
    for i, (B, C, Co, spatial, bias, x_bf16) in enumerate(k3_cases()):
        for transpose in (False, True):
            for w_dtype in (torch.float32, torch.bfloat16):
                # bfloat16 W with bfloat16 x at every shape (the blocks after a
                # network's first under bn_compute_dtype="compute"), and with
                # float32 x where the float32-BN flagship feeds it
                x_dtypes = ((torch.float32,) if w_dtype == torch.float32 else
                            (torch.bfloat16,) if x_bf16 else (torch.bfloat16, torch.float32))
                for x_dtype in x_dtypes:
                    args = k3_case(device, B, C, Co, spatial, bias, transpose, x_dtype, w_dtype,
                                   seed=40 + i)
                    got = k3_run(args)
                    kernels = k3_names(args[5])
                    if w_dtype == torch.float32:
                        ref = k3_plain(args, torch.float64)
                        errs = [close(a, r, rtol, 1e-5, f"{n} {(B, C, Co, spatial)} f32")
                                for a, r, n, rtol in zip(got, ref, names, (1e-5,) * 2 + (1e-4,) * 4)]
                    else:
                        ref = k3_plain(args)
                        ref = (ref[0].to(w_dtype),) + ref[1:]  # y rounded as the kernel stores it
                        errs = [close(a, r, 0.0, frac, f"{n} {(B, C, Co, spatial)} bf16")
                                for a, r, n, frac in zip(got, ref, names, (1e-2,) + (2e-2,) * 5)]
                        again = k3_run(args)
                        check(all(torch.equal(a, b) for a, b in zip(got, again)),
                              f"K3 {(B, C, Co, spatial)} bf16: two runs on the same inputs differ")
                    torch.cuda.synchronize()
                    worst[kernels["fwd"]] = max(worst[kernels["fwd"]], errs[0])
                    worst[kernels["dx"]] = max(worst[kernels["dx"]], errs[1])
                    for name in (kernels["pass_a"], "pointwise_bwd_finalize"):
                        worst[name] = max(worst[name], *errs[2:])
                    print(f"K3 vs plain (B,C,Co)={(B, C, Co)} spatial {spatial} "
                          f"{'transpose' if transpose else 'conv'} x {str(x_dtype)[6:]} "
                          f"W {str(w_dtype)[6:]}: max |Δ| "
                          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
                          + ("; two runs bitwise equal" if w_dtype == torch.bfloat16 else ""))
        del args, got, ref

    out = {}
    for i in K3_TIMED:
        B, C, Co, spatial, bias, x_bf16 = K3_CASES[i]
        args = k3_case(device, B, C, Co, spatial, bias, False,
                       torch.bfloat16 if x_bf16 else torch.float32, torch.bfloat16, seed=50 + i)
        shape = (f"(B,C,Co)={(B, C, Co)} spatial {spatial} x {str(args[0].dtype)[6:]} W bf16")
        timed = k3_times(args, shape, first=i == K3_TIMED[0])
        x3 = args[0]
        R = x3.shape[0] * x3.shape[2]
        rows, chunks = cuda_pointwise.reduce_tc_chunks(R, C, Co, x3.element_size())
        scratch = cuda_pointwise.pass_a_scratch_bytes(R, C, Co, chunks)
        inputs = cuda_pointwise.pass_a_input_bytes(R, C, Co, x3.element_size())
        print(f"K3 pointwise_bwd_reduce_tc {shape}: {chunks} chunks of {rows} rows; scratch "
              f"{scratch} B written and read against {inputs} B of inputs "
              f"({scratch / inputs:.3f})")
        block = fused_against_cudnn(args, spatial, bias)
        print(f"K3 block bn1→relu→conv1 {shape}, bf16 autocast: fused (K3's kernels) "
              f"fwd {block['fused_fwd']:.3f} ms, fwd+bwd {block['fused_fwd_bwd']:.3f} ms; "
              f"unfused cuDNN fwd {block['unfused_fwd']:.3f} ms, fwd+bwd "
              f"{block['unfused_fwd_bwd']:.3f} ms (median of 20 calls, CUDA events)")
        if i == K3_TIMED[0]:
            out.update(timed)
            out["pointwise_fwd_tc"]["block_ms"] = block
            out["pointwise_bwd_reduce_tc"].update(chunks=chunks, scratch_bytes=scratch,
                                                  input_bytes=inputs)
        del args
    B, C, Co, spatial, bias, _ = K3_CASES[K3_TIMED[0]]
    args = k3_case(device, B, C, Co, spatial, bias, False, torch.float32, torch.float32, seed=60)
    timed = k3_times(args, f"(B,C,Co)={(B, C, Co)} spatial {spatial} x float32 W float32",
                     first=True)
    out.update({name: timed[name] for name in F32_ONLY})
    for name, entry in out.items():
        entry.update(max_abs_err=worst[name], library_ms=None)
    return out


def stats_finalize_plain(part, counts, eps):
    """The finalize's plain version: the chunks' (mean, M2) [2, chunks, C]
    over ``counts`` [chunks] elements merged in one sum (Chan's formula
    over all chunks at once), then mean, var and inv."""
    n = counts.sum()
    w = counts[:, None]
    mean = (w * part[0]).sum(0) / n
    m2 = part[1].sum(0) + (w * (part[0] - mean).square()).sum(0)
    var = m2 / n
    return mean, var, PW.inv_std(var, eps)


def k3_stats_against_plain(device: torch.device, card_line: str) -> dict:
    """``pointwise_stats`` (partials + finalize, with bn1's running update)
    at every K3 case's shape (``k3_cases``), x float32 and bfloat16, each
    case run twice from the same buffers and bitwise equal: mean and var
    against a float64 oracle, |Δ| ≤ 1e-5·|ref| (the mean's floor
    1e-6·sqrt(var): a mean near zero is known to its spread's scale); inv
    against 1 / sqrt(var + eps) of
    the kernel's own var within 1 ulp; the running buffers within rtol 1e-6
    (atol 1e-6·max|ref|: a buffer near zero) of ``update_running_stats``
    from the kernel's statistics. Then timed at
    K3_TIMED (the largest block's x in bfloat16, as the flagship feeds it)
    against the plain path (``plain_stats``: the statistics as the fused op
    took them before) and against ``torch.var_mean``, the one PyTorch call
    computing mean and variance (after ``.float()`` for bfloat16 x)."""
    eps, worst = 1e-5, 0.0
    for i, (B, C, _, spatial, _, _) in enumerate(k3_cases()):
        for x_dtype in (torch.float32, torch.bfloat16):
            x3 = k3_case(device, B, C, C, spatial, False, False, x_dtype, torch.bfloat16,
                         seed=80 + i)[0]
            start = running_buffers(C, device, seed=81 + i)
            runs = []
            for _ in range(2):
                running = (start[0].clone(), start[1].clone(), start[2])
                runs.append((*cuda_pointwise.pointwise_stats_cuda(x3, eps, running), *running[:2]))
            mean, var, inv, rm, rv = runs[0]
            torch.cuda.synchronize()
            tag = f"(B,C,S)={(B, C, math.prod(spatial))} x {str(x_dtype)[6:]}"
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"pointwise_stats {tag}: two runs on the same inputs differ")
            ref_var, ref_mean = torch.var_mean(x3.double(), dim=(0, 2), correction=0)
            err_m = (mean.double() - ref_mean).abs()
            err_v = (var.double() - ref_var).abs()
            check(bool((err_m <= 1e-5 * ref_mean.abs() + 1e-6 * ref_var.sqrt()).all()),
                  f"pointwise_stats mean {tag}: max |Δ| {err_m.max().item():.3e}")
            check(bool((err_v <= 1e-5 * ref_var).all()),
                  f"pointwise_stats var {tag}: max |Δ|/var {(err_v / ref_var).max().item():.3e}")
            want = 1.0 / torch.sqrt(var + eps)
            ulps = (inv.view(torch.int32) - want.view(torch.int32)).abs().max().item()
            check(ulps <= 1, f"pointwise_stats inv {tag}: {ulps} ulp from 1/sqrt(var + eps)")
            plain = (start[0].clone(), start[1].clone(), start[2])
            PW.update_running_stats(*plain, mean, var, B * math.prod(spatial))
            for got, ref, what in ((rm, plain[0], "running_mean"), (rv, plain[1], "running_var")):
                bound = 1e-6 * (ref.abs() + ref.abs().max())
                check(bool(((got - ref).abs() <= bound).all()),
                      f"pointwise_stats {what} {tag}: max |Δ| {(got - ref).abs().max().item():.3e}")
            worst = max(worst, err_m.max().item(), err_v.max().item())
            print(f"pointwise_stats vs float64 {tag}: mean max |Δ| {err_m.max().item():.3e}, var "
                  f"max |Δ|/var {(err_v / ref_var).max().item():.3e}, inv {ulps} ulp; running "
                  "buffers within 1e-6; two runs bitwise equal")
            del x3, runs

    out = {}
    for i in K3_TIMED:
        B, C, _, spatial, _, x_bf16 = K3_CASES[i]
        x3 = k3_case(device, B, C, C, spatial, False, False,
                     torch.bfloat16 if x_bf16 else torch.float32, torch.bfloat16, seed=90 + i)[0]
        running = running_buffers(C, device, seed=91)
        S = x3.shape[2]
        per, chunks = cuda_pointwise.stats_chunks(B, C, S, x3.element_size())
        part = cuda_pointwise.pointwise_stats_partials_cuda(x3)
        counts = torch.tensor([(min(B, (k + 1) * per) - k * per) * S for k in range(chunks)],
                              dtype=torch.float32, device=device)
        xf = (lambda: x3) if x3.dtype == torch.float32 else x3.float
        timed = {
            "pointwise_stats": (lambda: cuda_pointwise.pointwise_stats_cuda(x3, eps, running),
                                lambda: plain_stats(x3, eps, running)),
            "pointwise_stats_finalize": (
                lambda: cuda_pointwise.pointwise_stats_finalize_cuda(part, B, S, per, eps,
                                                                     running),
                lambda: stats_finalize_plain(part, counts, eps))}
        bounds = k3_stats_bounds(x3)
        library_ms = cuda_ms(lambda: torch.var_mean(xf(), dim=(0, 2), correction=0), calls=20,
                             warmup=3)
        shape = f"(B,C,S)={(B, C, S)} x {str(x3.dtype)[6:]}"
        for name, (kernel_fn, plain_fn) in timed.items():
            k_ms = cuda_ms(kernel_fn, calls=20, warmup=3)
            p_ms = cuda_ms(plain_fn, calls=20, warmup=3)
            entry = {"max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms, **bounds[name],
                     "library_ms": library_ms if name == "pointwise_stats" else None}
            print(f"K3 {name} time {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                  f"{bounds[name]['bound_ms']:.4g} ms ({bounds[name]['bound_by']})"
                  + (f", torch.var_mean {library_ms:.4f} ms" if name == "pointwise_stats" else "")
                  + f" ({chunks} chunks; median of 20 calls, CUDA events) [{card_line}]")
            if i == K3_TIMED[0]:
                out[name] = entry
        del x3, part
    return out


# The bf16 train-mode BatchNorm's timed shapes (N, C, S): the resnet cells'
# largest maps, the second, and two of the smallest, 2-D (4×4) and 1-D; then
# DenseNet-121's at 256 px: norm0 (the stem, the largest map of any cell),
# the narrowest concatenation, a transition, block 3's widest concatenation
# and norm5 (one pass at the widest C)
BN_TIMED = ((256, 64, 4096), (256, 128, 1024), (256, 320, 16), (256, 320, 1),
            (256, 64, 16384), (256, 96, 4096), (256, 512, 1024), (256, 992, 256),
            (256, 1024, 64))
BN_ENTRIES = ("bn_fwd", "bn_bwd")  # one each a BatchNorm
BN_NHWC = ("bn_fwd_nhwc", "bn_bwd_nhwc")  # of those, the channels-last networks' 2-D ones
BN_EPS, BN_MOMENTUM = 1e-5, 0.1


def bn_per_step(cfg, nhwc: bool = False) -> int:
    """The BatchNorms of ``cfg``'s networks, each a train step's bn_fwd and
    bn_bwd where they take bfloat16 (``bn_compute_dtype="compute"`` under
    bf16): 96 for word, 108 for char. ``nhwc``: those of its channels-last
    networks (the 2-D ones), each a step's bn_fwd_nhwc and bn_bwd_nhwc."""
    model = MMVae(cfg)
    nets = ([net for net in model.children() if getattr(net, "channels_last", False)] if nhwc
            else [model])
    return sum(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
               for net in nets for m in net.modules())


def bn_launches_per_step(cfg) -> dict:
    """{BatchNorm count: launches a train step} of ``cfg``: bn_fwd, bn_bwd,
    bn_fwd_nhwc, bn_bwd_nhwc, and the inputs copied (bn_copies): one where
    the word text head is fused, the gradient K2's backward writes [B, L, C]
    for the word decoder's last shortcut BatchNorm (tests/
    test_torch_port_batchnorm.py), none otherwise."""
    return {**dict.fromkeys(BN_ENTRIES, bn_per_step(cfg)),
            **dict.fromkeys(BN_NHWC, bn_per_step(cfg, nhwc=True)),
            "bn_copies": int(cfg.fused_text_head)}


def bn_case(device, N: int, C: int, S: int, seed: int) -> tuple:
    """x bf16 [N, C, S] with a shift and scale a channel, dy bf16 with a
    bias, float32 weight, bias and running buffers."""
    g = torch.Generator(device=device).manual_seed(seed)
    shift = 2 * torch.randn(C, generator=g, device=device)
    scale = 0.1 + 3 * torch.rand(C, generator=g, device=device)
    x = (torch.randn(N, C, S, generator=g, device=device) * scale[:, None]
         + shift[:, None]).bfloat16()
    dy = (torch.randn(N, C, S, generator=g, device=device) + 0.3).bfloat16()
    return (x, dy, 0.5 + torch.rand(C, generator=g, device=device),
            torch.randn(C, generator=g, device=device), torch.randn(C, generator=g, device=device),
            0.5 + torch.rand(C, generator=g, device=device))


def bf16_ulp(ref: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of |ref|, float64."""
    r = ref.double().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(r)) - 7)


def bn_against_aten(device: torch.device, card_line: str) -> dict:
    """The BatchNorm kernels at ``BN_TIMED``, each shape on both plans: x
    [N, C, S] contiguous (``bn_fwd``, ``bn_bwd``) and the same values
    channels-last, [N·S, C] (``bn_fwd_nhwc``, ``bn_bwd_nhwc``): y against
    ATen's bf16 BatchNorm (``native_batch_norm``, what ``F.batch_norm``
    runs for a bf16 input with float32 weights) within 1 bf16 ulp plus 1e-5
    of the channel's terms; dx against a float64 reference within 2 ulps
    plus 1e-5 of its terms, and ATen's dx (``native_batch_norm_backward``)
    measured against the same reference (tests/test_torch_port_batchnorm.py's
    bounds, and why the backward is held to float64); two runs bitwise
    equal. Then each kernel's device time (profiler) beside the op's bound
    (10 bytes an element at 3.35 TB/s: 4 forward, 6 backward) and ATen's
    device time for the same call (``library_ms``). Keys ``bn_fwd``,
    ``bn_bwd``, ``bn_fwd_nhwc``, ``bn_bwd_nhwc``."""
    out = {}
    for i, (N, C, S) in enumerate(BN_TIMED):
        x, dy, w, b, rm, rv = bn_case(device, N, C, S, seed=150 + i)
        shape = f"(N,C,S)={(N, C, S)}"
        y_a, mean_a, inv_a = torch.ops.aten.native_batch_norm(x, w, b, rm.clone(), rv.clone(),
                                                              True, BN_MOMENTUM, BN_EPS)
        dx_a = torch.ops.aten.native_batch_norm_backward(
            dy, x, w, rm, rv, mean_a, inv_a, True, BN_EPS, [True, True, True])[0]
        xd, dyd, n = x.double(), dy.double(), N * S
        var64, mean64 = torch.var_mean(xd, dim=(0, 2), correction=0)
        inv64, xc = 1 / (var64 + BN_EPS).sqrt(), xd - mean64[:, None]
        proj, dmean = (dyd * xc).sum((0, 2)) / n * inv64 ** 2, dyd.sum((0, 2)) / n
        dx64 = (dyd - xc * proj[:, None] - dmean[:, None]) * (inv64 * w.double())[:, None]
        terms_dx = ((dyd.abs().amax((0, 2)) + xc.abs().amax((0, 2)) * proj.abs() + dmean.abs())
                    * inv64 * w.double().abs())
        bound_dx = 2 * bf16_ulp(dx64) + 1e-5 * terms_dx[:, None]
        aten_dx = float(((dx_a.double() - dx64).abs() / bound_dx).max())
        aten_fwd = sum(device_us_by_kernel(lambda: torch.ops.aten.native_batch_norm(
            x, w, b, rm.clone(), rv.clone(), True, BN_MOMENTUM, BN_EPS)).values())
        aten_bwd = sum(device_us_by_kernel(lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, w, rm, rv, mean_a, inv_a, True, BN_EPS, [True, True, True])).values())

        def rows(t):  # [N, C, S] → the channels-last [N·S, C]
            return t.transpose(1, 2).contiguous().view(N * S, C)

        def back(t):  # and back
            return t.view(N, S, C).transpose(1, 2)

        layouts = (
            ("", x, dy, cuda_batchnorm.bn_fwd_cuda, cuda_batchnorm.bn_bwd_cuda, lambda t: t,
             cuda_batchnorm.bn_plan(N, C, S, 8 if S % 8 == 0 else 1)),
            ("_nhwc", rows(x), rows(dy), cuda_batchnorm.bn_fwd_nhwc_cuda,
             cuda_batchnorm.bn_bwd_nhwc_cuda, back,
             cuda_batchnorm.bn_plan_nhwc(N * S, C, 8 if C % 8 == 0 else 1)))
        for suffix, xl, dyl, fwd_cuda, bwd_cuda, to_ncs, plan in layouts:
            def fwd():
                return fwd_cuda(xl, w, b, rm.clone(), rv.clone(), BN_EPS, BN_MOMENTUM)

            y, mean, invstd = fwd()

            def bwd():
                return bwd_cuda(xl, dyl, w, mean, invstd)

            dx, dw, db = bwd()
            again = (*fwd(), *bwd())
            torch.cuda.synchronize()
            check(all(torch.equal(a, c) for a, c in zip((y, mean, invstd, dx, dw, db), again)),
                  f"BatchNorm{suffix} {shape}: two runs on the same inputs differ")
            y, dx = to_ncs(y), to_ncs(dx)
            terms_y = (w.double().abs() * (xd - mean.double()[:, None]).abs().amax((0, 2))
                       * invstd.double() + b.double().abs())
            err_y = (y.double() - y_a.double()).abs() / (bf16_ulp(y_a) + 1e-5 * terms_y[:, None])
            err_dx = (dx.double() - dx64).abs() / bound_dx
            for what, err in (("y", err_y), ("dx", err_dx)):
                check(float(err.max()) <= 1, f"BatchNorm{suffix} {what} {shape}: |Δ| "
                                             f"{float(err.max()):.3f} of its bound")
            fwd_us = device_us_by_kernel(fwd)
            bwd_us = device_us_by_kernel(bwd)
            for entry, us, moved, aten in ((f"bn_fwd{suffix}", fwd_us, 4 * x.numel(), aten_fwd),
                                           (f"bn_bwd{suffix}", bwd_us, 6 * x.numel(), aten_bwd)):
                kernels = {k: v for k, v in us.items() if "bn_" in k}
                bound = least_time(moved, 0, torch.bfloat16)
                total_ms = sum(kernels.values()) / 1e3
                row = {"ms": total_ms, "kernels_ms": {k: v / 1e3 for k, v in kernels.items()},
                       "library_ms": aten / 1e3, **bound, "plan": plan._asdict()}
                out.setdefault(entry, {})[shape] = row
                print(f"BatchNorm {entry} {shape} ({'one pass' if plan.fused else 'two passes'}):"
                      " " + ", ".join(f"{k} {v:.2f} µs" for k, v in kernels.items())
                      + f"; {total_ms * 1e3:.2f} µs of device time against the bound "
                      f"{bound['bound_ms'] * 1e3:.2f} µs ({bound['bound_by']}) and ATen's "
                      f"{aten:.2f} µs (profiler) [{card_line}]")
            print(f"BatchNorm{suffix} {shape}: |Δ| of y from ATen's {float(err_y.max()):.3f} of "
                  f"its bound, of dx from float64 {float(err_dx.max()):.3f} (ATen's dx "
                  f"{aten_dx:.3f}); two runs bitwise equal")
            out[f"bn_bwd{suffix}"][shape]["aten_dx_of_bound"] = aten_dx
            del xl, dyl, y, dx, again
        del x, dy, y_a, dx_a
    return out


def k3_times(args, shape: str, first: bool) -> dict:
    """K3's kernels on ``args`` timed against their plain versions (CUDA
    events, median of 20 calls), pass A as one function (its partials
    kernel and their finalize together; the partials also alone), each
    beside its bound: {kernel: entry}."""
    x3, g, b, m, inv, w, cb, dy = args
    kernels = k3_names(w)
    parts = cuda_pointwise.pointwise_bwd_partials_cuda(x3, g, b, m, inv, w, dy)
    _, _, dg, db = cuda_pointwise.pointwise_bwd_finalize_cuda(*parts)
    timed = {
        kernels["fwd"]: (
            lambda: cuda_pointwise.pointwise_fwd_cuda(x3, g, b, m, inv, w, cb),
            lambda: PW.pointwise_fwd_plain(x3, g, b, m, inv, w, cb).to(w.dtype)),
        kernels["pass_a"]: (
            lambda: cuda_pointwise.pointwise_bwd_reduce_cuda(x3, g, b, m, inv, w, dy),
            lambda: PW.pointwise_bwd_reduce_plain(x3, g, b, m, inv, w, dy)),
        "pointwise_bwd_finalize": (
            lambda: cuda_pointwise.pointwise_bwd_finalize_cuda(*parts),
            lambda: (parts[0].sum(0), parts[1].sum(0), parts[2].sum((0, 1)),
                     parts[3].sum((0, 1)))),
        kernels["dx"]: (
            lambda: cuda_pointwise.pointwise_bwd_dx_cuda(x3, g, b, m, inv, w, dy, dg, db),
            lambda: PW.pointwise_bwd_dx_plain(x3, g, b, m, inv, w, dy, dg, db).to(x3.dtype)),
    }
    if w.dtype == torch.float32:  # the float32 run times only its own kernels
        timed = {kernels[f]: timed[kernels[f]] for f in ("fwd", "pass_a", "dx")}
    bounds = k3_bounds(x3, w, dy)
    partials_ms = cuda_ms(
        lambda: cuda_pointwise.pointwise_bwd_partials_cuda(x3, g, b, m, inv, w, dy),
        calls=20, warmup=3)
    out = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        k_ms = cuda_ms(kernel_fn, calls=20, warmup=3)
        p_ms = cuda_ms(plain_fn, calls=20, warmup=3)
        out[name] = {"ms": k_ms, "plain_ms": p_ms, **bounds[name]}
        what = f"{name} (pass A: partials + finalize)" if name == kernels["pass_a"] else name
        print(f"K3 {what} time {shape}: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound "
              f"{bounds[name]['bound_ms']:.4g} ms ({bounds[name]['bound_by']}) "
              "(median of 20 calls, CUDA events)")
    print(f"K3 {kernels['pass_a']}'s partials kernel alone {shape}: {partials_ms:.4f} ms "
          "(median of 20 calls, CUDA events)")
    if first:
        out[kernels["pass_a"]]["partials_ms"] = partials_ms
    return out


def fused_against_cudnn(args, spatial, bias) -> dict:
    """The block's bn1 → relu → conv1 under bf16 autocast, as the fused op
    (``pointwise_stats``, then K3) and as the unfused modules (cuDNN
    BatchNorm and convolution), forward and forward + backward, on the same
    input; both update bn's running statistics."""
    x3, _, _, _, _, _, _, dy = args
    B, C, S = x3.shape
    Co = dy.shape[1]
    two_d = len(spatial) == 2
    bn = (torch.nn.BatchNorm2d if two_d else torch.nn.BatchNorm1d)(C).to(x3.device)
    conv = (torch.nn.Conv2d if two_d else torch.nn.Conv1d)(C, Co, 1, bias=bias).to(x3.device)
    x = x3.reshape(B, C, *spatial).detach().requires_grad_()
    dy = dy.reshape(B, Co, *spatial)
    leaves = [x, *bn.parameters(), *conv.parameters()]

    def fused():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return PW.fused_bn_relu_pointwise(x, bn.weight, bn.bias,
                                              PW.conv1x1_matrix(conv.weight, False), conv.bias,
                                              bn.eps, torch.bfloat16,
                                              (bn.running_mean, bn.running_var, bn.momentum))[0]

    def unfused():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            return conv(torch.relu(bn(x.float())))

    times = {}
    for name, fn in (("fused", fused), ("unfused", unfused)):
        with torch.no_grad():
            times[f"{name}_fwd"] = cuda_ms(fn, calls=20, warmup=3)
        times[f"{name}_fwd_bwd"] = cuda_ms(lambda: torch.autograd.grad(fn(), leaves, dy),
                                           calls=20, warmup=3)
    return times


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def random_state_dict(cfg, seed: int = 0) -> dict:
    """Default-initialised weights from ``seed`` and BN running statistics
    drawn from a seeded generator, so that eval-mode BN does real work."""
    torch.manual_seed(seed)
    sd = MMVae(cfg).state_dict()
    gen = torch.Generator().manual_seed(seed + 1)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=gen)
        elif k.endswith("running_var"):
            sd[k] = 0.5 + 1.5 * torch.rand(v.shape, generator=gen)
    return sd


def text_ids(cfg, n: int, rng) -> np.ndarray:
    """Random text ids [n, L]: word ids, or char ids of the alphabet."""
    return rng.integers(0, cfg.num_features, (n, cfg.len_sequence))


def as_text_input(cfg, ids: np.ndarray) -> np.ndarray:
    """Text ids → the model's text input: word ids as they are, char ids as
    a float32 one-hot [n, L, 71] (the JAX layout)."""
    if cfg.text_encoding == "char":
        return np.eye(cfg.num_features, dtype=np.float32)[ids]
    return ids


def request(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s, c = cfg.img_size, cfg.image_channels
    return {
        "PA": rng.random((n, s, s, c), dtype=np.float32),
        "Lateral": rng.random((n, s, s, c), dtype=np.float32),
        "text": as_text_input(cfg, text_ids(cfg, n, rng).astype(np.int32)),
    }


def drive_slice(sess: InferenceSession, n_encode: int = 40, n_generate: int = 16,
                n_cond: int = 8) -> dict:
    """One pass over the three endpoints, as a client would call them."""
    cfg = sess.cfg
    return {
        "encode": sess.encode(request(cfg, n_encode, seed=10)),
        "generate": sess.generate(n_generate, seed=1),
        "generate_again": sess.generate(n_generate, seed=1),
        "cond": sess.cond_generate(request(cfg, n_cond, seed=11), seed=2),
        "cond_compact": sess.cond_generate(request(cfg, n_cond, seed=11), seed=2, compact=True),
    }


def check_slice(cfg, outs: dict, n_encode: int = 40, n_generate: int = 16,
                n_cond: int = 8) -> None:
    """Shapes as the JAX session gives them, finite values, probabilities
    summing to one, the compact wire types, determinism for a seed."""
    s, c, L, D = cfg.img_size, cfg.image_channels, cfg.len_sequence, cfg.class_dim
    V = cfg.num_features
    enc = outs["encode"]
    check(set(enc["subsets"]) == SUBSETS, f"encode subsets {sorted(enc['subsets'])}")
    for key, pair in list(enc["subsets"].items()) + [("joint", enc["joint"])]:
        for x in pair:
            check(x.shape == (n_encode, D), f"encode {key}: shape {x.shape}")
            check(np.isfinite(x).all(), f"encode {key}: non-finite values")

    def check_full(mods, n, where):
        for m in ("PA", "Lateral"):
            check(mods[m].shape == (n, s, s, c) and mods[m].dtype == np.float32,
                  f"{where} {m}: {mods[m].shape} {mods[m].dtype}")
            check(np.isfinite(mods[m]).all(), f"{where} {m}: non-finite values")
        t = mods["text"]
        check(t.shape == (n, L, V) and np.isfinite(t).all(), f"{where} text: {t.shape}")
        check(np.abs(t.sum(-1) - 1.0).max() < 1e-3, f"{where} text rows do not sum to 1")

    check_full(outs["generate"], n_generate, "generate")
    for m, v in outs["generate"].items():
        check(np.array_equal(v, outs["generate_again"][m]), f"generate {m}: seed not deterministic")
    check(set(outs["cond"]) == SUBSETS == set(outs["cond_compact"]), "cond_generate subsets")
    for key in SUBSETS:
        check_full(outs["cond"][key], n_cond, f"cond_generate[{key}]")
        cm = outs["cond_compact"][key]
        check(cm["text"].dtype == np.int32 and cm["text"].shape == (n_cond, L)
              and int(cm["text"].min()) >= 0 and int(cm["text"].max()) < V,
              f"cond_generate[{key}] compact text: {cm['text'].dtype} {cm['text'].shape}")
        for m in ("PA", "Lateral"):
            check(cm[m].dtype == np.uint8 and cm[m].shape == (n_cond, s, s, c),
                  f"cond_generate[{key}] compact {m}: {cm[m].dtype} {cm[m].shape}")


def gpu_against_cpu(cfg, sd, device: torch.device) -> float:
    """encode through K1 on the card vs the plain version on the CPU."""
    cfg32 = cfg.replace(compute_dtype="float32")
    batch = request(cfg32, 8, seed=12)
    got = InferenceSession(cfg32, state_dict=sd, device=device).encode(batch)
    ref = InferenceSession(cfg32, state_dict=sd, device="cpu").encode(batch)
    worst = 0.0
    pairs = [(k, got["subsets"][k], ref["subsets"][k]) for k in SUBSETS]
    for key, g_pair, r_pair in pairs + [("joint", got["joint"], ref["joint"])]:
        for g, r in zip(g_pair, r_pair):
            scale = float(np.abs(r).max())
            err = np.abs(g - r)
            check(bool((err <= 1e-4 * np.abs(r) + 1e-4 * scale).all()),
                  f"GPU vs CPU encode {key}: max |Δ| {err.max():.3e} (max|ref| {scale:.3e})")
            worst = max(worst, float(err.max()) / max(scale, 1e-30))
    print(f"GPU (K1) vs CPU (plain) encode, float32, TF32 off: max |Δ|/max|ref| {worst:.3e} "
          "(bound rtol 1e-4, atol 1e-4·max|ref|)")
    return worst


def p50_ms(fn, calls: int = 20, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()  # returns host numpy arrays: the device work is done
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def endpoint_timings(sess: InferenceSession, card_line: str) -> dict:
    """p50 of each endpoint at buckets 8 and 128: {"name bucket": ms}."""
    out = {}
    for bucket in (8, 128):
        batch = request(sess.cfg, bucket, seed=13)
        for name, fn in (
            ("encode", lambda: sess.encode(batch)),
            ("generate compact", lambda: sess.generate(bucket, seed=3, compact=True)),
            ("cond_generate compact", lambda: sess.cond_generate(batch, seed=3, compact=True)),
        ):
            ms = out[f"{name} {bucket}"] = p50_ms(fn)
            print(f"p50 {name} bucket {bucket} ({sess.cfg.text_encoding} text, "
                  f"{sess.cfg.compute_dtype}): {ms:.3f} ms [{card_line}]")
    return out


# ---------------------------------------------------------------------------
# the training slice
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    return {**cuda_fusion.LAUNCHES, **cuda_texthead.LAUNCHES, **cuda_pointwise.LAUNCHES,
            **cuda_batchnorm.LAUNCHES}


def reset_launch_counts() -> None:
    for counts in (cuda_fusion.LAUNCHES, cuda_texthead.LAUNCHES, cuda_pointwise.LAUNCHES,
                   cuda_batchnorm.LAUNCHES):
        for name in counts:
            counts[name] = 0


def training_batch(cfg, n: int, seed: int, device) -> dict:
    """A seeded batch in the port's layouts: uniform images [n, C, H, W]
    and random token ids [n, L] (char: their one-hot [n, L, 71]), on
    ``device``."""
    rng = np.random.default_rng(seed)
    s, c = cfg.img_size, cfg.image_channels
    arrays = {
        "PA": rng.random((n, c, s, s), dtype=np.float32),
        "Lateral": rng.random((n, c, s, s), dtype=np.float32),
        "text": as_text_input(cfg, text_ids(cfg, n, rng).astype(np.int64)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def drive_training(cfg, device, kernels=K12, per_step=None, warmup: int = 3, steps: int = 10,
                   seed: int = 0) -> dict:
    """``steps`` + ``warmup`` train steps on one seeded batch, as a user
    calls ``make_train_step``. Checks every step's loss terms, that each of
    ``kernels`` launched in every step (exactly ``per_step[name]`` times
    where given), and at the end that parameters and BN running statistics
    moved. Returns the step's p50 and the launches of the run."""
    state = create_train_state(cfg, device, seed=seed)
    train_step = make_train_step(cfg)
    batch = training_batch(cfg, cfg.batch_size, seed + 1, device)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    times, metrics = [], None
    reset_launch_counts()
    for i in range(warmup + steps):
        counts = launch_counts()
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        for name in kernels:
            check(launch_counts()[name] > counts[name], f"train step {i}: {name} did not launch")
        for name, n in (per_step or {}).items():
            got = launch_counts()[name] - counts[name]
            check(got == n, f"train step {i}: {name} launched {got} times, not {n}")
        for name, v in loss_terms(metrics).items():
            check(bool(torch.isfinite(v)), f"train step {i}: {name} = {float(v)}")
        check(not bool(metrics["nan_in_latents"]), f"train step {i}: NaN in latents")
        g = float(metrics["grad_norm"])
        check(np.isfinite(g) and g > 0, f"train step {i}: grad_norm {g}")
    launches = launch_counts()

    after = state.model.state_dict()
    params = {k for k, _ in state.model.named_parameters()}
    moved = [k for k in params if not torch.equal(before[k], after[k])]
    check(all(bool(torch.isfinite(after[k]).all()) for k in params), "non-finite parameters")
    check(len(moved) >= 0.9 * len(params), f"only {len(moved)} of {len(params)} parameters moved")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    frozen = [k for k in stats if torch.equal(before[k], after[k])]
    check(stats and not frozen, f"BN running statistics did not move: {frozen[:3]}")
    p50 = statistics.median(times[warmup:])
    return {"state": state, "step": train_step, "batch": batch, "metrics": metrics,
            "launches": launches, "p50_ms": p50, "samples_per_s": cfg.batch_size / p50 * 1e3,
            "params_moved": (len(moved), len(params))}


def steps_in_turns(runs: dict, steps: int = 5) -> dict:
    """Each run's step timed in turns on the same card (the first run, the
    second, the second, the first; ``steps`` steps a turn, each ending in a
    synchronize): the p50 per run, a comparison less exposed to drift
    between the runs than their own p50s."""
    first, second = runs
    times = {first: [], second: []}
    for path in (first, second, second, first):
        run = runs[path]
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = run["step"](run["state"], run["batch"])
            torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(metrics["total_loss"])), f"{path}: total_loss not finite")
    return {path: statistics.median(t) for path, t in times.items()}


def kernel_name(event_name: str) -> str:
    """The __global__ function's name in a profiler event's name (no
    namespace, template arguments or parameters)."""
    fn = re.match(r"(?:void )?([A-Za-z_]\w*)", event_name.replace("(anonymous namespace)::", ""))
    return fn.group(1) if fn else event_name


def device_profile(fn, steps: int = 3) -> dict:
    """``torch.profiler`` over one call of ``fn``, which runs ``steps``
    steps and ends in a synchronize (after one unprofiled call): per step,
    the wall time, the device busy time (union of the kernel and copy
    intervals recorded on the card), the device ops, and the device time by
    op name; the device's idle share of the wall. ``busy_ms`` is None where
    the profiler recorded no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device_events)
    out = {"wall_ms": wall_us / steps / 1e3, "busy_ms": None, "idle_pct": None,
           "ops": len(spans) / steps, "by_name_ms": {}}
    if not spans:
        return out
    by_name = {}
    for e in device_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    out.update(busy_ms=busy / steps / 1e3, idle_pct=100.0 * (1.0 - busy / wall_us),
               by_name_ms={name: t / steps / 1e3 for name, t in by_name.items()})
    return out


def device_idle_share(fn, calls: int = 3) -> str:
    """``device_profile`` of ``calls`` calls of ``fn`` as a line: wall and
    device busy per call, the idle share, device ops per call, the device
    ops that take the most time and the port's own kernels."""
    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    prof = device_profile(run, calls)
    if prof["busy_ms"] is None:
        return "device idle share: not measured (the profiler recorded no device events)"
    top = sorted(prof["by_name_ms"].items(), key=lambda kv: -kv[1])[:8]
    ours = {}  # the port's own kernels, by the name of their __global__ function
    for name, t in prof["by_name_ms"].items():
        fn_name = kernel_name(name)
        if fn_name.startswith(("texthead_", "poe_subsets", "pointwise_")):
            ours[fn_name] = ours.get(fn_name, 0.0) + t
    return (f"device idle share over {calls} calls (profiled): wall {prof['wall_ms']:.3f} ms"
            f"/call, device busy {prof['busy_ms']:.3f} ms/call, idle "
            f"{prof['idle_pct']:.1f}%, {int(prof['ops'])} device ops/call; "
            "top device time per call: "
            + "; ".join(f"{name[:60]} {t:.3f} ms" for name, t in top)
            + "; the port's kernels per call: "
            + "; ".join(f"{name} {t:.4f} ms" for name, t in sorted(ours.items())))


# the latent block around K1, which must not wait for the host
LATENT_FILES = ("mopoe_mimic_tpu_torch/ops/fusion.py", "mopoe_mimic_tpu_torch/ops/cuda_fusion.py",
                "mopoe_mimic_tpu_torch/models/mmvae.py")


def sync_site(stack) -> str:
    """Where a synchronizing operation arose: the innermost frame of
    ``stack`` (``traceback.extract_stack``) in the port's package, else in
    this repository, else the innermost, as "path:line (function)"."""
    def where(frame):
        try:
            return Path(frame.filename).resolve().relative_to(ROOT).as_posix()
        except ValueError:
            return None

    ours = [f for f in stack if (where(f) or "").startswith("mopoe_mimic_tpu_torch/")]
    frame = (ours or [f for f in stack if where(f)] or list(stack))[-1]
    return f"{where(frame) or frame.filename}:{frame.lineno} ({frame.name})"


def synchronizing_ops(fn) -> dict:
    """Each synchronizing CUDA operation that ``fn`` makes, as PyTorch's
    sync debug mode reports it (``torch.cuda.set_sync_debug_mode("warn")``:
    a warning per operation): {site (``sync_site``): count}. An operation
    of the backward pass is reported where ``backward`` was called."""
    import traceback
    import warnings

    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            site = sync_site(traceback.extract_stack()[:-1])
            sites[site] = sites.get(site, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sites


def check_latent_block_syncs(run: dict) -> dict:
    """One more train step of ``run`` under the sync debug mode: prints the
    synchronizing operations and where they arose; fails if one arose in
    the latent block around K1 (LATENT_FILES)."""
    sites = synchronizing_ops(lambda: run["step"](run["state"], run["batch"]))
    latent = {site: n for site, n in sites.items() if site.startswith(LATENT_FILES)}
    print(f"synchronizing operations in one train step: {sum(sites.values())}"
          + "".join(f"; {n} at {site}" for site, n in sorted(sites.items())))
    check(not latent, f"the latent block synchronizes with the host: {latent}")
    return sites


def one_step_grads(cfg, sd, device, batch) -> tuple:
    """One train step, dropout off and eps = 0, from the weights ``sd``:
    (loss terms, {parameter: gradient on the CPU})."""
    state = create_train_state(cfg, device, state_dict=sd)
    for mod in state.model.modules():
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
            mod.p = 0.0
    metrics = make_train_step(cfg, eps=0.0)(state, batch)
    terms = {k: float(v) for k, v in loss_terms(metrics).items()}
    grads = {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()}
    return terms, grads


# the gradients the kernels produce or pass on directly: K2's dW and db,
# and the heads that K1's backward feeds
KERNEL_ADJACENT = ("decoder_text.text_generator.generator.6.", ".feature_compressor.")


def gpu_step_against_cpu(cfg, device, kernels=K12, n: int = 8, seed: int = 14) -> dict:
    """One float32 train step through the kernels on the card against one
    through the plain versions on the CPU, same weights and batch.

    Loss terms within rtol 1e-4. Gradients: the tensors the kernels produce
    or feed (``KERNEL_ADJACENT``) within 1e-3·max|g| of that tensor; all
    of them together within 1e-3 relative (L2); every tensor within
    1e-3·max|g| of the tensor plus 1e-3·max|g| of the model. The floor is
    float32's, not the kernels': at init this architecture's BatchNorms
    make some tensors ill-conditioned, so that the plain float32 CPU step
    misses a float64 step by up to 4% of such a tensor's max, and the
    card's float32 convolution and BatchNorm reductions (cuDNN, float
    accumulators) by up to 6%, with or without the kernels. The float64
    step's distances are printed."""
    cfg = cfg.replace(batch_size=n, compute_dtype="float32")
    cfg64 = cfg.replace(compute_dtype="float64", param_dtype="float64")
    torch.manual_seed(0)
    sd = MMVae(cfg).state_dict()
    batch = training_batch(cfg, n, seed=seed, device="cpu")
    before = launch_counts()
    got, g_gpu = one_step_grads(cfg, sd, device, batch)
    check(all(launch_counts()[k] > before[k] for k in kernels if k not in BF16_ONLY),
          "GPU train step did not launch every kernel")
    check(all(launch_counts()[k] == before[k] for k in BF16_ONLY if k in K3),
          "a float32 train step launched a bfloat16 kernel")
    ref, g_cpu = one_step_grads(cfg, sd, "cpu", batch)
    _, g64 = one_step_grads(cfg64, sd, "cpu", batch)
    for name in ref:
        check(abs(got[name] - ref[name]) <= 1e-4 * abs(ref[name]),
              f"GPU vs CPU train step {name}: {got[name]!r} vs {ref[name]!r}")
    rel = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)

    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    flat = lambda d: torch.cat([d[k].double().flatten() for k in sorted(d)])  # noqa: E731
    l2 = {"gpu_vs_cpu": float((flat(g_gpu) - flat(g_cpu)).norm() / flat(g_cpu).norm()),
          "gpu_vs_f64": float((flat(g_gpu) - flat(g64)).norm() / flat(g64).norm()),
          "cpu_vs_f64": float((flat(g_cpu) - flat(g64)).norm() / flat(g64).norm())}
    check(l2["gpu_vs_cpu"] <= 1e-3, f"GPU vs CPU gradients: relative L2 {l2['gpu_vs_cpu']:.3e}")
    adjacent = 0.0
    for k, r in g_cpu.items():
        scale = float(r.abs().max())
        err = float((g_gpu[k] - r).abs().max())
        if any(part in k for part in KERNEL_ADJACENT):
            check(err <= 1e-3 * scale, f"GPU vs CPU gradient {k}: max |Δ| {err:.3e} "
                                       f"(max|g| {scale:.3e})")
            adjacent = max(adjacent, err / scale)
        check(err <= 1e-3 * (scale + g_max), f"GPU vs CPU gradient {k}: max |Δ| {err:.3e} "
                                             f"(max|g| {scale:.3e}, model {g_max:.3e})")
    knobs = "fused_text_head" + (", fused_pointwise" if cfg.fused_pointwise else "")
    print(f"GPU (kernels) vs CPU (plain) train step ({knobs}), float32, batch {n}, TF32 off: "
          f"loss terms max rel |Δ| {rel:.3e} (bound 1e-4); gradients rel L2: GPU vs CPU "
          f"{l2['gpu_vs_cpu']:.3e} (bound 1e-3), GPU vs float64 {l2['gpu_vs_f64']:.3e}, CPU "
          f"float32 vs float64 {l2['cpu_vs_f64']:.3e}; kernel-adjacent tensors max|Δ|/max|g| "
          f"{adjacent:.3e} (bound 1e-3)")
    return l2


# ---------------------------------------------------------------------------
# the epoch path: the card-resident store and the graphed epoch
# ---------------------------------------------------------------------------

EPOCH_ROWS = 16384  # rows of the phase's SyntheticMimic (seed 0)
EPOCH_PARITY_STEPS = 8  # graphed against eager steps, batch 8, float32
EPOCH_TIMED_STEPS = 20  # steps a turn of the timing (G E E G)
# the __global__ function each kernel of training A and B launches, as the
# trace of a replay names it
REPLAYED = {"poe_subsets_f32": "poe_subsets_f32_kernel",
            "poe_subsets_bwd_f32": "poe_subsets_bwd_f32_kernel",
            "texthead_fwd": "texthead_fwd_tc", "texthead_bwd_dh": "texthead_bwd_dh_tc",
            "texthead_bwd_dw": "texthead_bwd_dw_tc",
            "texthead_bwd_dw_finalize": "texthead_bwd_dw_finalize_kernel",
            # training B's bfloat16 K3 kernels
            "pointwise_stats": "pointwise_stats_kernel",
            "pointwise_stats_finalize": "pointwise_stats_finalize_kernel",
            "pointwise_fwd_tc": "pointwise_fwd_tc",
            "pointwise_bwd_reduce_tc": "pointwise_bwd_reduce_tc",
            "pointwise_bwd_finalize": "pointwise_bwd_finalize_kernel",
            "pointwise_bwd_dx_tc": "pointwise_bwd_dx_tc"}


def epoch_store(cfg, device, rows: int = EPOCH_ROWS) -> tuple:
    """A ``SyntheticMimic`` of ``rows`` rows (seed 0) in a ``DeviceStore``:
    (store, its report: bytes, growth of the card's allocated memory, and a
    gathered batch checked against the host's columns: images equal to the
    quantised rows times float32(1/255) bit for bit, word ids equal, char
    text the one-hot of the host column's argmax)."""
    allocated = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
    t0 = time.perf_counter()
    dataset = SyntheticMimic(cfg, seed=0, length=rows)
    store = DeviceStore(dataset, cfg, device=device)
    _sync(device)
    seconds = time.perf_counter() - t0
    grown = (torch.cuda.memory_allocated(device) - allocated) if device.type == "cuda" else 0
    idx = np.random.default_rng(1).integers(0, rows, 64).astype(np.int32)
    batch = store.gather(idx)
    for k in ("PA", "Lateral"):
        u8 = np.round(np.clip(dataset.arrays[k][idx], 0.0, 1.0) * 255.0).astype(np.uint8)
        ref = u8.transpose(0, 3, 1, 2).astype(np.float32) * np.float32(1 / 255)
        check(batch[k].cpu().numpy().tobytes() == ref.tobytes(), f"store gather {k} differs")
    text = dataset.arrays["text"][idx]
    if cfg.text_encoding == "char":  # one byte a character on the card
        text, text_bytes = as_text_input(cfg, np.argmax(text, axis=-1)), cfg.len_sequence
    else:
        text_bytes = 4 * cfg.len_sequence
    check(np.array_equal(batch["text"].cpu().numpy(), text), "store gather text differs")
    expected = rows * (2 * cfg.img_size ** 2 * cfg.image_channels + text_bytes)
    check(store.nbytes == expected, f"store holds {store.nbytes} B, not {expected}")
    return store, {"rows": rows, "bytes": store.nbytes, "allocated_bytes": grown,
                   "build_s": seconds}


def _zero_dropout(state) -> None:
    for mod in state.model.modules():
        if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
            mod.p = 0.0


def epoch_parity(cfg, store, device, steps: int = EPOCH_PARITY_STEPS, n: int = 8) -> dict:
    """``steps`` graphed steps (``make_train_epoch``, one row an epoch, so
    each step's terms are read) against as many eager ``make_train_step``
    steps on the same ``epoch_index_matrix`` rows, from the same weights and
    generator state, batch ``n``, float32, dropout 0: every loss term within
    rtol 1e-5 at every step, the parameters after within 1e-5 relative L2;
    the generators' states equal after every step and changed by every
    step (each replay draws new noise, the eager step's). Prints whether
    the two runs are bitwise equal."""
    cfg = cfg.replace(batch_size=n, compute_dtype="float32")
    sd = create_train_state(cfg, device, seed=0).model.state_dict()
    graphed, eager = (create_train_state(cfg, device, state_dict=sd, seed=5) for _ in range(2))
    for state in (graphed, eager):
        _zero_dropout(state)
    train_epoch, train_step = make_train_epoch(cfg, store), make_train_step(cfg)
    rows = epoch_index_matrix(store, 0, n, steps_cap=steps)
    check(len(rows) == steps, f"{len(rows)} rows, not {steps}")
    worst, bitwise, seen = 0.0, True, set()
    for i, row in enumerate(rows):
        _, means = train_epoch(graphed, row[None])
        ref = {k: float(v) for k, v in loss_terms(train_step(eager, store.gather(row))).items()}
        got = {k: float(v) for k, v in loss_terms(means).items()}
        check(got.keys() == ref.keys(), f"graphed step {i}: terms {sorted(got)}")
        for k, r in ref.items():
            check(np.isfinite(r) and abs(got[k] - r) <= 1e-5 * abs(r),
                  f"graphed vs eager step {i} {k}: {got[k]!r} vs {r!r}")
            worst = max(worst, abs(got[k] - r) / abs(r))
            bitwise &= got[k] == r
        g_state = graphed.generator.get_state()
        check(torch.equal(g_state, eager.generator.get_state()),
              f"step {i}: the graphed generator's state is not the eager one's")
        check(bytes(g_state.numpy()) not in seen, f"step {i}: the replay drew no new noise")
        seen.add(bytes(g_state.numpy()))
    check(graphed.step == eager.step == steps, f"steps {graphed.step} / {eager.step}")
    params = [k for k, _ in graphed.model.named_parameters()]
    got_sd, ref_sd = graphed.model.state_dict(), eager.model.state_dict()
    flat = lambda d: torch.cat([d[k].double().flatten() for k in params])  # noqa: E731
    l2 = float((flat(got_sd) - flat(ref_sd)).norm() / flat(ref_sd).norm())
    check(l2 <= 1e-5, f"graphed vs eager parameters: relative L2 {l2:.3e}")
    bitwise &= all(torch.equal(got_sd[k], ref_sd[k]) for k in got_sd)
    print(f"graphed epoch vs eager steps ({cfg.img_size} px, DIM {cfg.DIM_img}, batch {n}, "
          f"float32, TF32 off, dropout 0, {steps} steps): loss terms max rel |Δ| {worst:.3e} (bound 1e-5), parameters rel "
          f"L2 {l2:.3e} (bound 1e-5), bitwise equal: {bitwise}; the generators' states equal "
          "after every step, new at every step")
    return {"steps": steps, "batch": n, "terms_max_rel": worst, "params_rel_l2": l2,
            "bitwise": bitwise}


def replay_kernel_counts(fn, steps: int, expect=(), attempts: int = 4) -> dict:
    """{__global__ function: launches a step} from a ``torch.profiler``
    trace of ``fn`` (``steps`` steps a call), for the port's kernels; the
    profiler now and then drops a session's kernels, so sessions are taken
    until one records each kernel of ``expect`` a whole number of times a
    step (up to ``attempts``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = kernel_name(e.name)
                if name.startswith(("texthead_", "poe_subsets", "pointwise_")):
                    counts[name] = counts.get(name, 0) + 1
        if all(counts.get(g, 0) and counts[g] % steps == 0 for g in expect):
            break
    return {name: c / steps for name, c in counts.items()}


def cuda_event_ms(fn, steps: int) -> float:
    """ms a step of ``fn`` (``steps`` steps a call) between CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def epoch_training(cfg, store, device, card_line: str, per_step: dict) -> dict:
    """A training run through the graphed epoch, as a user calls it: the
    flagship's batch from ``epoch_index_matrix``, ``make_train_epoch``
    (captured at its first call, replayed a step); every epoch mean finite,
    parameters and BN running statistics changed, the kernels of
    ``per_step`` ({kernel: launches a step}) counted by their wrappers
    exactly ``per_step`` times for each warm-up step and each of the 13
    replays (the capture's own launches are not counted); in a
    trace of 3 replays each such kernel ``per_step`` times a step; no
    synchronising operation in an epoch but its one read; then the graphed
    epoch against the eager store-fed loop (``make_train_step`` on
    ``store.gather`` of the same rows, one state) in turns G E E G of
    ``EPOCH_TIMED_STEPS`` steps (CUDA events), a 3-step profile of each,
    and the gather's device time."""
    state = create_train_state(cfg, device, seed=0)
    train_epoch, train_step = make_train_epoch(cfg, store), make_train_step(cfg)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    b = cfg.batch_size
    # two epochs' orders: the phase runs 13 + 3 + 3 + 4 × 20 + 3 steps
    rows = np.concatenate([epoch_index_matrix(store, e, b) for e in (0, 1)])
    check(len(rows) >= 19 + 4 * EPOCH_TIMED_STEPS + 3, f"{len(rows)} rows in two epochs")
    reset_launch_counts()
    t0 = time.perf_counter()
    _, means = train_epoch(state, rows[:13])
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    for name, n in per_step.items():
        want = (WARMUP_STEPS + 13) * n
        check(launches[name] == want, f"graphed epoch: {name} launched {launches[name]} times, "
                                      f"not {want} ({WARMUP_STEPS} warm-up steps and 13 replays "
                                      f"of {n})")
    for name, v in loss_terms(means).items():
        check(np.isfinite(v), f"graphed epoch mean {name} = {v}")
    check(np.isfinite(means["grad_norm"]) and means["grad_norm"] > 0,
          f"graphed epoch grad_norm {means['grad_norm']}")
    check(means["nan_in_latents"] == 0.0, "graphed epoch: NaN in latents")
    after = state.model.state_dict()
    params = {k for k, _ in state.model.named_parameters()}
    moved = [k for k in params if not torch.equal(before[k], after[k])]
    check(len(moved) >= 0.9 * len(params), f"only {len(moved)} of {len(params)} parameters moved")
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    frozen = [k for k in stats if torch.equal(before[k], after[k])]
    check(stats and not frozen, f"BN running statistics did not move: {frozen[:3]}")
    check(state.step == 13, f"host step {state.step}")
    terms = {k: round(float(v), 4) for k, v in loss_terms(means).items()}
    knobs = ("fused_text_head" + (", fused_pointwise" if cfg.fused_pointwise else "")
             + (", bn_compute_dtype=compute" if cfg.bn_compute_dtype == "compute" else ""))
    print(f"graphed epoch ({cfg.img_size} px, DIM {cfg.DIM_img}, {knobs}, "
          f"batch {b}, {cfg.compute_dtype}): 13 steps "
          f"ok in {first_s:.1f} s with the capture; wrapper launches {launches}; params moved "
          f"({len(moved)}, {len(params)}); epoch means {terms}")

    expect = {REPLAYED[name]: n for name, n in per_step.items() if n and name in REPLAYED}
    replayed = replay_kernel_counts(lambda: train_epoch(state, rows[13:16]), 3, expect)
    check(replayed == expect, f"replay trace: kernels a step {replayed}, not {expect}")
    print(f"kernels a replayed step (trace of 3 replays): {replayed}")

    sites = synchronizing_ops(lambda: train_epoch(state, rows[16:19]))
    print(f"synchronizing operations in a 3-step graphed epoch: {sum(sites.values())}"
          + "".join(f"; {n} at {site}" for site, n in sorted(sites.items())))
    check(sum(sites.values()) == 1 and all(site.startswith("mopoe_mimic_tpu_torch/train/scan.py")
                                           for site in sites),
          f"the graphed epoch synchronizes other than at its one read: {sites}")

    dev_rows = torch.from_numpy(rows).to(device)

    def eager(lo: int, hi: int):
        for r in dev_rows[lo:hi]:
            metrics = train_step(state, store.gather(r))
        return metrics

    times = {"graphed": [], "eager": []}
    lo = 19
    for path in ("graphed", "eager", "eager", "graphed"):
        hi = lo + EPOCH_TIMED_STEPS
        run = ((lambda lo=lo, hi=hi: train_epoch(state, rows[lo:hi])) if path == "graphed"
               else (lambda lo=lo, hi=hi: eager(lo, hi)))
        times[path].append(cuda_event_ms(run, EPOCH_TIMED_STEPS))
        lo = hi
    check(bool(torch.isfinite(state.step_t)), "step count")
    profiles = {"graphed": device_profile(lambda: train_epoch(state, rows[lo:lo + 3]), 3),
                "eager": device_profile(lambda: eager(lo, lo + 3), 3)}
    gather_ms = device_us(lambda: store.gather_fn(store.cols, dev_rows[0]))
    timing = {}
    for path in ("graphed", "eager"):
        ms = statistics.mean(times[path])
        prof = profiles[path]
        timing[path] = {"ms_per_step": times[path], "samples_per_s": [b / t * 1e3 for t in
                                                                       times[path]],
                        "device_busy_ms": prof["busy_ms"], "idle_pct": prof["idle_pct"],
                        "device_ops": prof["ops"], "profiled_wall_ms": prof["wall_ms"]}
        print(f"{knobs} {path} (batch {b}, {cfg.compute_dtype}, in turns G E E G, "
              f"{EPOCH_TIMED_STEPS} steps "
              f"a turn, CUDA events): "
              + ", ".join(f"{t:.3f}" for t in times[path]) + f" ms a step (mean {ms:.3f}), "
              + ", ".join(f"{b / t * 1e3:.1f}" for t in times[path]) + " samples/s; 3-step "
              f"profile: device busy {prof['busy_ms']} ms a step, idle {prof['idle_pct']}% of "
              f"{prof['wall_ms']:.3f} ms, {prof['ops']:.0f} device ops a step [{card_line}]")
    print(f"store gather (batch {b}): {gather_ms[0] / 1e3:.4f} ms of device time "
          f"({gather_ms[1]})")
    return {"launches": launches, "replayed_per_step": replayed, "syncs": sites,
            "first_call_s": first_s, "timing": timing, "gather_ms": gather_ms[0] / 1e3,
            "gather_how": gather_ms[1], "params_moved": [len(moved), len(params)]}


TRAINING_C_STEPS = 13  # steps of A and C compared loss for loss
BN_NAMES = ("bn_", "batch_norm", "batchnorm")  # BatchNorm kernels of cuDNN and ATen


def bn_device_ms(by_name: dict) -> dict:
    """BatchNorm's forward and backward device time (ms a step) in a
    profile's time by kernel name: names with ``bn_``, ``batch_norm`` or
    ``batchnorm``, backward where they hold ``bw`` or ``backward``."""
    out = {"fwd_ms": 0.0, "bwd_ms": 0.0, "kernels": []}
    for name, t in by_name.items():
        low = name.lower()
        if any(k in low for k in BN_NAMES):
            out["bwd_ms" if ("bw" in low or "backward" in low) else "fwd_ms"] += t
            # the function's own name, with its library's namespace (the
            # port's kernels' anonymous one left out)
            short = name.removeprefix("void ").replace("(anonymous namespace)::", "")
            out["kernels"].append(re.split(r"[<(]", short)[0])
    out["kernels"] = sorted(set(out["kernels"]))
    return out


def training_c_against_a(cfg_a, store, device, card_line: str) -> dict:
    """Training C (A with ``bn_compute_dtype="compute"``: the JAX production
    diet, bench.py:153-154) against A through the graphed epoch, from the
    same weights, rows and dropout draws: ``TRAINING_C_STEPS`` steps of
    each, one row a call, so each step's terms are read; every term finite
    and C's total loss within 5e-2 relative of A's at every step (the bound
    of JAX's test_bn_compute_dtype_bf16_finite_and_close). Then both in
    turns A C C A of ``EPOCH_TIMED_STEPS`` steps (CUDA events) and a 3-step
    profile of each: device busy, idle share, device ops, and BatchNorm's
    forward and backward device time a step."""
    paths = {"A": cfg_a, "C": cfg_a.replace(bn_compute_dtype="compute")}
    b = cfg_a.batch_size
    rows = np.concatenate([epoch_index_matrix(store, e, b) for e in (0, 1)])
    check(len(rows) >= TRAINING_C_STEPS + 4 * EPOCH_TIMED_STEPS + 12, f"{len(rows)} rows")
    runs, losses = {}, {}
    for path, cfg in paths.items():
        state = create_train_state(cfg, device, seed=0)
        train_epoch = make_train_epoch(cfg, store)
        torch.manual_seed(11)  # the same dropout draws in both runs
        losses[path] = []
        for i in range(TRAINING_C_STEPS):
            _, means = train_epoch(state, rows[i:i + 1])
            for name, v in loss_terms(means).items():
                check(np.isfinite(v), f"training {path} step {i}: {name} = {v}")
            check(means["nan_in_latents"] == 0.0, f"training {path} step {i}: NaN in latents")
            losses[path].append(means["total_loss"])
        runs[path] = (state, train_epoch)
    rel = [abs(c - a) / abs(a) for a, c in zip(losses["A"], losses["C"])]
    check(max(rel) <= 5e-2, f"training C against A: total loss rel |Δ| {max(rel):.3e} > 5e-2")
    print(f"training C (bn_compute_dtype=compute) against A, graphed, {TRAINING_C_STEPS} steps "
          f"from the same weights, rows and dropout draws: total loss rel |Δ| max "
          f"{max(rel):.3e} (bound 5e-2), last step A {losses['A'][-1]:.4f}, C "
          f"{losses['C'][-1]:.4f} [{card_line}]")

    times = {"A": [], "C": []}
    lo = TRAINING_C_STEPS
    for path in ("A", "C", "C", "A"):
        state, train_epoch = runs[path]
        hi = lo + EPOCH_TIMED_STEPS
        times[path].append(cuda_event_ms(
            lambda lo=lo, hi=hi: train_epoch(state, rows[lo:hi]), EPOCH_TIMED_STEPS))
        lo = hi
    out = {"steps": TRAINING_C_STEPS, "total_loss_rel_max": max(rel),
           "losses": {p: [round(v, 4) for v in ls] for p, ls in losses.items()}}
    for path, (state, train_epoch) in runs.items():
        prof = device_profile(lambda: train_epoch(state, rows[lo:lo + 3]), 3)
        bn = bn_device_ms(prof["by_name_ms"])
        out[path] = {"ms_per_step": times[path], "device_busy_ms": prof["busy_ms"],
                     "idle_pct": prof["idle_pct"], "device_ops": prof["ops"],
                     "bn_fwd_ms": bn["fwd_ms"], "bn_bwd_ms": bn["bwd_ms"],
                     "bn_kernels": bn["kernels"]}
        print(f"training {path} graphed (batch {b}, bf16, BatchNorm in "
              f"{'bfloat16' if path == 'C' else 'float32'}; in turns A C C A, "
              f"{EPOCH_TIMED_STEPS} steps a turn, CUDA events): "
              + ", ".join(f"{t:.3f}" for t in times[path]) + " ms a step; 3-step profile: "
              f"device busy {prof['busy_ms']} ms a step, idle {prof['idle_pct']}%, "
              f"{prof['ops']:.0f} device ops a step; BatchNorm forward {bn['fwd_ms']:.3f} ms, "
              f"backward {bn['bwd_ms']:.3f} ms a step ({', '.join(bn['kernels'])}) "
              f"[{card_line}]")
        lo += 6
    return out


# ---------------------------------------------------------------------------
# the training CLI: main → Experiment → run_epochs over the graphed epoch
# ---------------------------------------------------------------------------

CLI_ROWS = 2048  # rows of each synthetic split (train seed 0, test seed 1)
CLI_EPOCHS, CLI_STEPS = 2, 8  # epochs, steps an epoch (2048 rows / batch 256)
CLI_ROOT = ROOT / "build" / "cli_runs"  # run directories of the phase (git-ignored)


def cli_argv(root: Path, *extra) -> list:
    """The training CLI's command line for training C at the flagship: the
    JAX production diet (``fused_text_head``, ``bn_compute_dtype=compute``),
    batch 256, the card-resident store of ``CLI_ROWS`` rows and the graphed
    epoch, ``CLI_EPOCHS`` epochs of ``CLI_STEPS`` steps, a checkpoint every
    epoch, seed 0, run directories under ``root``."""
    return ["--config_path", str(FLAGSHIP), "--dataset", "testing", "--eval_lr", "false",
            "--calc_nll", "false", "--use_clf", "false", "--device_resident_data", "true",
            "--fused_text_head", "true", "--bn_compute_dtype", "compute",
            "--lr_warmup_steps", str(TRAIN_WARMUP_STEPS), "--batch_size", "256",
            "--synthetic_length", str(CLI_ROWS), "--end_epoch", str(CLI_EPOCHS),
            "--steps_per_training_epoch", str(CLI_STEPS), "--checkpoint_freq", "1",
            "--seed", "0", "--dir_experiment", str(root), *extra]


def check_cli_run(root: Path, epochs: int, argv: list) -> dict:
    """The one run directory under ``root`` as ``epochs`` epochs of the CLI
    on ``argv`` leave it: ``config.json`` as ``argv`` parses (the diet's
    knobs, the widths, the batch, the store's rows), a checkpoint each
    epoch, and its row in the results CSV."""
    runs = [p for p in root.iterdir() if p.is_dir()]
    check(len(runs) == 1, f"{root}: run directories {runs}")
    run = runs[0]
    with open(run / "config.json") as f:
        saved = json.load(f)
    parsed = MopoeConfig.from_cli(argv)
    want = {k: getattr(parsed, k) for k in (
        "bn_compute_dtype", "fused_text_head", "device_resident_data", "batch_size",
        "synthetic_length", "DIM_img", "img_size", "compute_dtype", "seed", "text_encoding",
        "len_sequence")}
    check(saved["bn_compute_dtype"] == "compute" and all(saved[k] == v for k, v in want.items()),
          f"{run.name}/config.json: {({k: saved[k] for k in want})}, not {want}")
    kept = sorted(int(p.name) for p in (run / "checkpoints").iterdir() if p.name.isdigit())
    check(kept == list(range(epochs)), f"{run.name}: checkpoints {kept}")
    with open(root / "experiments_dataframe.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    check(len(rows) == 1 and rows[0]["str_experiment"] == run.name
          and float(rows[0]["total_epochs"]) == epochs - 1, f"{root}: CSV rows {rows}")
    return {"run": run, "checkpoint_bytes": (run / "checkpoints" / str(epochs - 1)
                                             / "state.pt").stat().st_size}


def train_state_tensors(state) -> dict:
    """Every tensor a resume must give back: parameters and buffers, Adam's
    state, the step count, the state's and the default generators."""
    opt = state.optimizer
    out = dict(state.model.state_dict())
    for i, p in enumerate(p for g in opt.param_groups for p in g["params"]):
        out.update({f"adam/{i}/{k}": v.detach().clone() for k, v in opt.state[p].items()})
    device = state.step_t.device
    out.update(step_t=state.step_t.clone(), generator=state.generator.get_state(),
               default_generator=(torch.cuda.get_rng_state(device) if device.type == "cuda"
                                  else torch.get_rng_state()))
    return out


def cli_training(device, card_line: str, direct_ms: float, extra: tuple = ()) -> dict:
    """Phase 10: the training CLI at the flagship's full width (``cli_argv``).
    Once as a user runs it, ``python -m mopoe_mimic_tpu_torch.main`` in a
    process of its own (exit 0, two epoch lines, the run directory); once
    in this process through ``main``, its launches counted (K1 and K2 > 0,
    K3 none); once for 1 epoch and then ``--load_run`` for 1 more, which
    must equal the straight run bit for bit in parameters, BN buffers, Adam
    state, step count and generators (cuDNN deterministic). The straight
    run's epochs split into train pass, test pass, callbacks and checkpoint
    write, and its train pass a step against ``direct_ms``, training C's
    graphed epoch called directly (phase 9). ``extra`` flags go to every
    run (the CPU rehearsal's small widths)."""
    device = torch.device(device)

    def argv(root: Path, *more) -> list:
        return cli_argv(root, *extra, *more)

    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mopoe_mimic_tpu_torch.main",
                           *argv(CLI_ROOT / "process"), "--device", device.type], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m mopoe_mimic_tpu_torch.main exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    epoch_lines = [line for line in proc.stderr.splitlines() if "train_loss=" in line]
    check(len(epoch_lines) == CLI_EPOCHS, f"the CLI's epoch lines: {epoch_lines}")
    split_re = (r"epoch (\d+) split: train pass ([\d.]+) s, test pass ([\d.]+) s, callbacks "
                r"([\d.]+) s \(checkpoint write ([\d.]+) s\)")
    process_split = {int(m[0]): dict(zip(("train", "test", "callbacks", "checkpoint"),
                                         map(float, m[1:])))
                     for m in re.findall(split_re, proc.stderr)}
    check(sorted(process_split) == list(range(CLI_EPOCHS)), "the CLI's epoch split lines")
    process = check_cli_run(CLI_ROOT / "process", CLI_EPOCHS, argv(CLI_ROOT))
    print(f"python -m mopoe_mimic_tpu_torch.main (training C, flagship, batch 256, "
          f"{CLI_ROWS}-row store, {CLI_EPOCHS} epochs × {CLI_STEPS} steps): exit 0 in "
          f"{wall:.1f} s; " + "; ".join(line.split(" INFO ")[-1] for line in epoch_lines)
          + f"; {process['run'].name}: config.json, checkpoints 0-{CLI_EPOCHS - 1} "
          f"({process['checkpoint_bytes']} B each), its CSV row [{card_line}]")

    reset_launch_counts()
    straight = train_cli.main(argv(CLI_ROOT / "straight"), device=device)
    launches = launch_counts()
    ref = train_state_tensors(straight["state"])
    for name in KERNELS:
        check((launches[name] > 0) == (name in K12 and device.type == "cuda"),
              f"CLI run: {name} launched {launches[name]} times")
    check(straight["epochs_run"] == CLI_EPOCHS and straight["state"].step == CLI_EPOCHS * CLI_STEPS,
          f"CLI run: {straight['epochs_run']} epochs, step {straight['state'].step}")
    check_cli_run(CLI_ROOT / "straight", CLI_EPOCHS, argv(CLI_ROOT))
    history = straight["history"]
    for h in history:
        check(np.isfinite(h["train_loss"]) and np.isfinite(h["test_loss"]), f"CLI epoch {h}")
    del straight

    train_cli.main(argv(CLI_ROOT / "resumed", "--end_epoch", "1"), device=device)
    (run,) = [p for p in (CLI_ROOT / "resumed").iterdir() if p.is_dir()]
    resumed = train_cli.main(["--load_run", str(run), "--end_epoch", str(CLI_EPOCHS)],
                             device=device)
    check(resumed["epochs_run"] == 1 and resumed["history"][0]["epoch"] == 1,
          f"--load_run ran {resumed['epochs_run']} epochs")
    got = train_state_tensors(resumed["state"])
    del resumed
    check(got.keys() == ref.keys(), "resumed state's tensors differ in names")
    unequal = [k for k in ref if not torch.equal(got[k], ref[k])]
    worst = max((float((got[k].double() - ref[k].double()).abs().max()
                       / ref[k].double().abs().max().clamp_min(1e-30)) for k in unequal
                 if ref[k].is_floating_point()), default=0.0)
    print(f"--load_run (1 epoch, then 1 more) against the straight {CLI_EPOCHS} epochs: "
          f"{len(ref) - len(unequal)} of {len(ref)} tensors bitwise equal"
          + (f"; largest relative difference {worst:.3e} in {unequal[:4]}" if unequal else "")
          + f" (cuDNN deterministic) [{card_line}]")
    check(not unequal, f"the resumed run differs from the straight one in {len(unequal)} "
          f"tensors, largest relative difference {worst:.3e}: {unequal[:6]}")

    splits = {"process": [process_split[e] for e in range(CLI_EPOCHS)],
              "this_process": [h["seconds"] for h in history]}
    loop_ms = {where: [e["train"] / CLI_STEPS * 1e3 for e in split]
               for where, split in splits.items()}
    for where, label in (("process", "its own process, cuDNN's default algorithms"),
                         ("this_process", "this process, cuDNN deterministic")):
        print(f"CLI epochs (training C, batch 256, in {label}): "
              + "; ".join(f"epoch {e}: train pass {s['train']:.3f} s, test pass "
                          f"{s['test']:.3f} s, callbacks {s['callbacks']:.3f} s of which the "
                          f"checkpoint write {s['checkpoint']:.3f} s"
                          for e, s in enumerate(splits[where]))
              + f"; the loop's train pass {loop_ms[where][-1]:.3f} ms a step at epoch "
              f"{CLI_EPOCHS - 1} (epoch 0 {loop_ms[where][0]:.3f}, with the captures) against "
              f"{direct_ms:.3f} ms a step of make_train_epoch called directly (phase 9, "
              f"training C, cuDNN deterministic) [{card_line}]")
    return {"subprocess_s": wall, "launches": launches, "split_s": splits,
            "loop_ms_per_step": loop_ms, "direct_ms_per_step": direct_ms,
            "checkpoint_bytes": process["checkpoint_bytes"], "resume_bitwise": True}


def cli_autotune(device, card_line: str) -> dict:
    """``autotune_batch_size`` at the flagship under training C's diet, from
    batch 256: each probe's peak (one eager train step on the card) and the
    batch picked."""
    cfg = MopoeConfig.from_cli(cli_argv(CLI_ROOT / "autotune"))
    probes = []

    def probe(c):
        try:
            peak = step_memory_bytes(c, device)
        except DeviceOutOfMemory as e:
            probes.append({"batch": c.batch_size, "peak_bytes": None, "oom": str(e)[:120]})
            raise
        probes.append({"batch": c.batch_size, "peak_bytes": peak})
        return peak

    t0 = time.perf_counter()
    picked = autotune_batch_size(cfg, probe_fn=probe, device=device)
    seconds = time.perf_counter() - t0
    total = torch.cuda.mem_get_info(device)[1]
    fits = [p["batch"] for p in probes if p["peak_bytes"] and p["peak_bytes"] <= 0.9 * total]
    check(fits and picked == max(fits), f"autotune picked {picked}; probes {probes}")
    print(f"autotune (training C, flagship, budget 0.9 × {total} B): "
          + "; ".join(f"batch {p['batch']} peak {p['peak_bytes']} B" if p["peak_bytes"] else
                      f"batch {p['batch']} out of memory" for p in probes)
          + f"; picked {picked} in {seconds:.1f} s [{card_line}]")
    return {"probes": probes, "picked": picked, "memory_bytes": total, "seconds": seconds}


# ---------------------------------------------------------------------------
# char-1024 text, and serving from a run directory
# ---------------------------------------------------------------------------

CHAR_ROOT = ROOT / "build" / "char_runs"  # run directories of phase 11 (git-ignored)
SERVE_SAMPLES, GRID_PER_ROW = 16, 8  # the serve CLI's samples, a grid row's images
REPORTS = ("no acute cardiopulmonary process.", "the lungs are clear. no pleural effusion.",
           "mild cardiomegaly, no focal consolidation", "stable appearance of the chest",
           "small left pleural effusion; atelectasis at the left base",
           "heart size normal. no pneumothorax.", "interval removal of the right picc line",
           "ET tube 4 cm above the carina")


def char_cli_argv(root: Path, *extra) -> list:
    """``cli_argv`` (training C at the flagship) with char-1024 text."""
    return cli_argv(root, "--text_encoding", "char", *extra)


def char_cli_training(device, card_line: str = "", extra: tuple = ()) -> dict:
    """Phase 11's training: ``python -m mopoe_mimic_tpu_torch.main
    --text_encoding char`` in a process of its own, training C's diet at the
    flagship (``fused_text_head``, which char ignores), exit 0 with its two
    epoch lines, ``config.json`` (char, length 1024), a checkpoint each
    epoch and the CSV row. ``extra`` flags: the CPU rehearsal's widths."""
    device = torch.device(device)
    shutil.rmtree(CHAR_ROOT, ignore_errors=True)
    argv = char_cli_argv(CHAR_ROOT / "train", *extra)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mopoe_mimic_tpu_torch.main", *argv,
                           "--device", device.type], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m mopoe_mimic_tpu_torch.main --text_encoding char "
          f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    epoch_lines = [line for line in proc.stderr.splitlines() if "train_loss=" in line]
    check(len(epoch_lines) == CLI_EPOCHS, f"the char CLI's epoch lines: {epoch_lines}")
    run = check_cli_run(CHAR_ROOT / "train", CLI_EPOCHS, argv)
    print(f"python -m mopoe_mimic_tpu_torch.main --text_encoding char (training C, flagship "
          f"width, char-1024, {CLI_ROWS}-row store, {CLI_EPOCHS} epochs × {CLI_STEPS} steps): "
          f"exit 0 in {wall:.1f} s; " + "; ".join(line.split(" INFO ")[-1] for line in
                                                  epoch_lines)
          + f"; {run['run'].name}: config.json, checkpoints 0-{CLI_EPOCHS - 1} "
          f"({run['checkpoint_bytes']} B each), its CSV row [{card_line}]")
    return {"run": run["run"], "subprocess_s": wall, "checkpoint_bytes": run["checkpoint_bytes"]}


def png_size(path: Path) -> tuple:
    """(width, height) of a PNG file, from its signature and IHDR chunk."""
    head = path.read_bytes()[:24]
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path}: not a PNG")
    return tuple(int.from_bytes(head[i:i + 4], "big") for i in (16, 20))


def served_epoch(run: Path) -> int:
    """The epoch a session must serve from ``run``: the checkpoint manager's
    best by test loss, else its latest (the JAX session's rule)."""
    mgr = CheckpointManager(str(run / "checkpoints"))
    best = mgr.best_epoch()
    return mgr.latest_epoch() if best is None else best


def serve_cli(run: Path, device, card_line: str = "") -> dict:
    """``python -m mopoe_mimic_tpu_torch.serve --run_dir RUN --num_samples
    16`` in a process of its own: exit 0, the served epoch the manager's
    pick, ``PA.png`` and ``Lateral.png`` PNGs of the grid's size, and
    ``text_probs.npy`` [16, L, classes] of finite rows summing to 1."""
    device = torch.device(device)
    cfg = MopoeConfig.from_json(str(run / "config.json"))
    out = run / "serving"
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mopoe_mimic_tpu_torch.serve", "--run_dir",
                           str(run), "--num_samples", str(SERVE_SAMPLES), "--device",
                           device.type], cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m mopoe_mimic_tpu_torch.serve --run_dir {run.name} "
          f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    epoch = re.search(r"serving epoch (\d+) from", proc.stderr)
    check(epoch is not None and int(epoch[1]) == served_epoch(run),
          f"the serve CLI served {epoch and epoch[1]}, not epoch {served_epoch(run)}")
    rows = -(-SERVE_SAMPLES // GRID_PER_ROW)
    for m in ("PA", "Lateral"):
        size = png_size(out / f"{m}.png")
        check(size == (GRID_PER_ROW * cfg.img_size, rows * cfg.img_size), f"{m}.png: {size}")
    probs = np.load(out / "text_probs.npy")
    check(probs.shape == (SERVE_SAMPLES, cfg.len_sequence, cfg.num_features)
          and np.isfinite(probs).all() and np.abs(probs.sum(-1) - 1.0).max() < 1e-3,
          f"text_probs.npy: {probs.shape}")
    print(f"python -m mopoe_mimic_tpu_torch.serve --run_dir ({cfg.text_encoding} text, epoch "
          f"{epoch[1]}, {SERVE_SAMPLES} samples): exit 0 in {wall:.1f} s; PA.png and "
          f"Lateral.png {size[0]}×{size[1]}, text_probs.npy {list(probs.shape)} [{card_line}]")
    return {"seconds": wall, "epoch": int(epoch[1]), "png_size": list(size),
            "text_probs_shape": list(probs.shape)}


def serve_run_dir(run: Path, device, card_line: str = "", timed: bool = True) -> dict:
    """A session on a run directory, in this process: the restored epoch the
    manager's best or latest; ``encode`` of 40 rows bit for bit that of a
    session on the same checkpoint's state_dict; the slice's endpoints
    (``drive_slice``: ``generate`` of 16 twice identical, ``cond_generate``
    of 8 full and compact) checked as phase 4 checks them; ``text_array``
    → ``cond_generate`` → ``decode_text`` giving 8 strings, and
    ``decode_text`` of ``text_array`` giving the reports back; K1 launched
    and K2, K3 not (on the card); with ``timed``, each endpoint's p50 at
    buckets 8 and 128."""
    device = torch.device(device)
    reset_launch_counts()
    sess = InferenceSession(run_dir=str(run), device=device)
    cfg = sess.cfg
    check(sess.epoch == served_epoch(run), f"session served epoch {sess.epoch}, not "
                                           f"{served_epoch(run)}")
    _, payload = CheckpointManager(str(run / "checkpoints")).read(sess.epoch)
    direct = InferenceSession(cfg, state_dict=payload["model"], device=device)
    batch = request(cfg, 40, seed=10)
    got, ref = sess.encode(batch), direct.encode(batch)
    pairs = [got["joint"]] + [got["subsets"][k] for k in SUBSETS]
    refs = [ref["joint"]] + [ref["subsets"][k] for k in SUBSETS]
    check(all(np.array_equal(a, b) for p, r in zip(pairs, refs) for a, b in zip(p, r)),
          "encode of the run-directory session differs from the state_dict session's")
    del direct
    check_slice(cfg, drive_slice(sess))
    text = sess.text_array(REPORTS)
    decoded = sess.decode_text(text)
    if cfg.text_encoding == "char":
        check(text.shape == (len(REPORTS), cfg.len_sequence, cfg.num_features),
              f"text_array: {text.shape}")
        check(all(d.startswith(r.lower() + "$") for d, r in zip(decoded, REPORTS)),
              f"decode_text(text_array(reports)): {[d[:40] for d in decoded]}")
    images = request(cfg, len(REPORTS), seed=15)
    cond = sess.cond_generate({"PA": images["PA"], "Lateral": images["Lateral"], "text": text},
                              seed=4, compact=True)
    strings = sess.decode_text(cond["Lateral_PA_text"]["text"])
    check(len(strings) == len(REPORTS) and all(len(t) == cfg.len_sequence for t in strings),
          f"decode_text of cond_generate: {len(strings)} rows")
    launches = launch_counts()
    if device.type == "cuda":
        check(launches["poe_subsets_f32"] > 0, "the run-directory session did not launch K1")
        check(not any(launches[k] for k in KERNELS if k != "poe_subsets_f32"),
              f"the session launched other kernels than K1's forward: {launches}")
    print(f"InferenceSession(run_dir=...) ({cfg.text_encoding} text, {cfg.compute_dtype}): "
          f"epoch {sess.epoch}; encode 40 bitwise the state_dict session's; generate 16 ×2, "
          f"cond_generate 8 full and compact ok; text_array → cond_generate → decode_text: "
          f"{strings[0][:32]!r}...; K1 launches {launches['poe_subsets_f32']} [{card_line}]")
    out = {"epoch": sess.epoch, "launches": launches}
    if timed:
        out["p50_ms"] = endpoint_timings(sess, card_line)
    return out


def char_block_shape(cfg) -> tuple:
    """(C, S) of the input to the char networks' largest 1-D residual block
    (most elements a row, the longer length first): read off a forward of
    the char text encoder and decoder at ``cfg``'s widths, on the CPU."""
    from mopoe_mimic_tpu_torch.models.resblocks import _ResidualBlock
    from mopoe_mimic_tpu_torch.models.text_networks import DecoderText, EncoderText

    cfg = cfg.replace(text_encoding="char")
    shapes = []
    nets = (EncoderText(cfg.DIM_text, cfg.class_dim, cfg.num_features, cfg.len_sequence,
                        text_encoding="char"),
            DecoderText(cfg.DIM_text, cfg.class_dim, cfg.num_features, cfg.len_sequence,
                        text_encoding="char"))
    for net in nets:
        for mod in net.modules():
            if isinstance(mod, _ResidualBlock):
                mod.register_forward_pre_hook(lambda m, args: shapes.append(args[0].shape[1:]))
    with torch.no_grad():
        nets[0].eval()(torch.zeros(2, cfg.len_sequence, cfg.num_features))
        nets[1].eval()(torch.zeros(2, cfg.class_dim))
    C, S = max(shapes, key=lambda cs: (cs[0] * cs[1], cs[1]))
    return int(C), int(S)


def char_against_word(device, card_line: str) -> dict:
    """Char C against word C through the graphed epoch at the flagship
    (training C's diet, batch 256, bf16; each on a store of ``CLI_ROWS``
    rows): 13 steps each (the capture included), the epoch means finite,
    each wrapper counting its launches a step for each warm-up step and
    replay (K1's two once, K2's four once under word only, K3 none); in a
    trace of 3 replays K1 forward and backward once a step
    and, under word only, K2's four; one synchronising operation in an
    epoch; then both in turns (word, char, char, word;
    ``EPOCH_TIMED_STEPS`` steps a turn, CUDA events), and a 3-step profile
    of each: device busy, idle share, device ops a step and the device
    operations that take the most time."""
    cfg_w = MopoeConfig.from_cli(cli_argv(CHAR_ROOT / "unused"))
    paths = {"word": cfg_w, "char": cfg_w.replace(text_encoding="char")}
    b = cfg_w.batch_size
    runs = {}
    for path, cfg in paths.items():
        store, report = epoch_store(cfg, device, CLI_ROWS)
        rows = np.concatenate([epoch_index_matrix(store, e, b) for e in range(10)])
        state = create_train_state(cfg, device, seed=0)
        train_epoch = make_train_epoch(cfg, store)
        reset_launch_counts()
        _, means = train_epoch(state, rows[:13])
        launches = launch_counts()
        for name, v in loss_terms(means).items():
            check(np.isfinite(v), f"{path} C graphed epoch mean {name} = {v}")
        check(means["nan_in_latents"] == 0.0, f"{path} C graphed epoch: NaN in latents")
        per_step = {"poe_subsets_f32": 1, "poe_subsets_bwd_f32": 1,
                    **(K2_PER_STEP if path == "word" else {})}
        bn = bn_launches_per_step(cfg)
        for name in (*KERNELS, *bn):
            want = (WARMUP_STEPS + 13) * bn.get(name, per_step.get(name, 0))
            check(launches[name] == want,
                  f"{path} C: {name} launched {launches[name]} times, not {want}")
        expect = {REPLAYED[name]: n for name, n in per_step.items()}
        replayed = replay_kernel_counts(lambda: train_epoch(state, rows[13:16]), 3, expect)
        check(replayed == expect, f"{path} C replay trace: kernels a step {replayed}, "
                                  f"not {expect}")
        sites = synchronizing_ops(lambda: train_epoch(state, rows[16:19]))
        check(sum(sites.values()) == 1
              and all(site.startswith("mopoe_mimic_tpu_torch/train/scan.py") for site in sites),
              f"{path} C: the graphed epoch synchronizes other than at its one read: {sites}")
        print(f"{path} C graphed (flagship, batch {b}, bf16, {cfg.text_encoding} text length "
              f"{cfg.len_sequence}; store {report['bytes']} B): 13 steps ok; wrapper launches "
              f"{launches}; kernels a replayed step {replayed}; synchronizing operations in a "
              f"3-step epoch {sum(sites.values())} [{card_line}]")
        runs[path] = {"state": state, "epoch": train_epoch, "rows": rows, "launches": launches,
                      "replayed_per_step": replayed, "store_bytes": report["bytes"],
                      "syncs": sum(sites.values())}

    times, cursor = {"word": [], "char": []}, {"word": 19, "char": 19}
    for path in ("word", "char", "char", "word"):
        run, lo = runs[path], cursor[path]
        cursor[path] = hi = lo + EPOCH_TIMED_STEPS
        times[path].append(cuda_event_ms(
            lambda: run["epoch"](run["state"], run["rows"][lo:hi]), EPOCH_TIMED_STEPS))
    out = {}
    for path, run in runs.items():
        lo = cursor[path]
        prof = device_profile(lambda: run["epoch"](run["state"], run["rows"][lo:lo + 3]), 3)
        top = sorted(prof["by_name_ms"].items(), key=lambda kv: -kv[1])[:6]
        out[path] = {"ms_per_step": times[path],
                     "samples_per_s": [b / t * 1e3 for t in times[path]],
                     "device_busy_ms": prof["busy_ms"], "idle_pct": prof["idle_pct"],
                     "device_ops": prof["ops"], "top_ops_ms": {n[:80]: t for n, t in top},
                     **{k: run[k] for k in ("launches", "replayed_per_step", "store_bytes",
                                            "syncs")}}
        print(f"{path} C graphed (batch {b}, bf16; in turns word char char word, "
              f"{EPOCH_TIMED_STEPS} steps a turn, CUDA events): "
              + ", ".join(f"{t:.3f}" for t in times[path]) + " ms a step, "
              + ", ".join(f"{b / t * 1e3:.1f}" for t in times[path]) + " samples/s; 3-step "
              f"profile: device busy {prof['busy_ms']} ms a step, idle {prof['idle_pct']}%, "
              f"{prof['ops']:.0f} device ops a step; top device time a step: "
              + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top) + f" [{card_line}]")
    return out


STEP_SEEDS = range(14, 22)  # batch seeds for the char step, phase 8's first
ULP_PROBES = 4  # one-ulp nudges of the images a seed is probed with


def stable_step_seed(cfg, n: int = 8, seeds=STEP_SEEDS) -> tuple:
    """The first batch seed of ``seeds`` at which a float32 step on the CPU
    is stable to float32's rounding: its gradients move by at most a
    quarter of phase 8's relative-L2 bound (2.5e-4) when the images are
    nudged by one ulp (``ULP_PROBES`` nudges of random signs). At a batch
    where float32's rounding decides a branch (a ReLU's input, or a pixel's
    x − loc in the Laplace term, within rounding of the kink), and the
    branch moves every gradient (BatchNorm at 1×1 spatial at batch 8), two
    float32 evaluations disagree with each other by more than the bound
    whatever computes them; a comparison of two devices is then decided by
    which side of the kink each one's rounding falls. Weights as
    ``gpu_step_against_cpu`` takes them. (seed, {seed: largest move})."""
    cfg = cfg.replace(batch_size=n, compute_dtype="float32")
    torch.manual_seed(0)
    sd = MMVae(cfg).state_dict()
    flat = lambda d: torch.cat([d[k].double().flatten() for k in sorted(d)])  # noqa: E731
    moves = {}
    for seed in seeds:
        batch = training_batch(cfg, n, seed=seed, device="cpu")
        _, ref = one_step_grads(cfg, sd, "cpu", batch)
        worst = 0.0
        for k in range(ULP_PROBES):
            gen = torch.Generator().manual_seed(100 + k)
            nudged = {m: v * (1 + (torch.randint(0, 2, v.shape, generator=gen) * 2 - 1)
                              * 2.0 ** -23) if m in ("PA", "Lateral") else v
                      for m, v in batch.items()}
            _, got = one_step_grads(cfg, sd, "cpu", nudged)
            worst = max(worst, float((flat(got) - flat(ref)).norm() / flat(ref).norm()))
        moves[seed] = worst
        print(f"{cfg.text_encoding} float32 step on the CPU, batch seed {seed}: gradients move "
              f"by up to {worst:.3e} (relative L2) under {ULP_PROBES} one-ulp nudges of the "
              f"images (stable below 2.5e-4)")
        if worst <= 2.5e-4:
            return seed, moves
    check(False, f"no batch seed of {list(seeds)} gives a float32 step stable to rounding: "
                 f"{moves}")


def char_and_serving(device, card_line: str, word_run: Path) -> dict:
    """Phase 11: char-1024 text and serving from a run directory, at the
    flagship's full width. The training CLI with ``--text_encoding char``
    (``char_cli_training``); the serve CLI on that run and on phase 10's
    word run (``serve_cli``); a session on the char run in this process
    (``serve_run_dir``), its launches counted; one float32 char train step
    on the card against one on the CPU (phase 8's check and tolerances: K1
    launched, K2 not) at the first batch seed from phase 8's at which
    float32 is itself stable (``stable_step_seed``); char C against word C
    through the graphed epoch (``char_against_word``)."""
    device = torch.device(device)
    torch.cuda.empty_cache()  # the CLIs' own processes share the card
    out = {"cli": char_cli_training(device, card_line)}
    char_run = out["cli"]["run"]
    out["cli"]["run"] = char_run.name
    out["serve_cli"] = {"char": serve_cli(char_run, device, card_line),
                        "word": serve_cli(word_run, device, card_line)}
    out["session"] = serve_run_dir(char_run, device, card_line)
    char_cfg = MopoeConfig.from_json(str(FLAGSHIP)).replace(text_encoding="char",
                                                            fused_text_head=True)
    seed, moves = stable_step_seed(char_cfg)
    reset_launch_counts()
    out["gpu_step_against_cpu"] = gpu_step_against_cpu(
        char_cfg, device, kernels=("poe_subsets_f32", "poe_subsets_bwd_f32"), seed=seed)
    out["gpu_step_against_cpu"].update(seed=seed, ulp_moves=moves)
    launches = launch_counts()
    check(not any(launches[k] for k in KERNELS if k not in ("poe_subsets_f32",
                                                           "poe_subsets_bwd_f32")),
          f"the char step launched other kernels than K1's: {launches}")
    out["graphed"] = char_against_word(device, card_line)
    return out


def epoch_capture_raises(cfg, device) -> str:
    """On the card ``make_train_epoch`` captures or raises: with an
    objective that waits for the host (a synchronize in the image
    likelihood), its first call must raise, leaving the state as it was,
    not train eagerly. Run last: a failed capture may leave the capture
    stream's memory pool open."""
    from mopoe_mimic_tpu_torch.train import losses

    cfg = cfg.replace(img_size=64, DIM_img=4, DIM_text=4, class_dim=4, batch_size=4)
    store = DeviceStore(SyntheticMimic(cfg, seed=0, length=8), cfg, device=device)
    state = create_train_state(cfg, device, seed=0)
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    plain = losses.laplace_log_prob

    def waits(*args):
        torch.cuda.synchronize()
        return plain(*args)

    losses.laplace_log_prob = waits
    try:
        make_train_epoch(cfg, store)(state, epoch_index_matrix(store, 0, 4))
        raised = None
    except RuntimeError as err:
        raised = f"{type(err).__name__}: {str(err).splitlines()[0][:120]}"
    finally:
        losses.laplace_log_prob = plain
    check(raised is not None, "make_train_epoch did not raise on an uncapturable step")
    check(state.step == 0 and all(torch.equal(v, before[k])
                                  for k, v in state.model.state_dict().items()),
          "a failed capture changed the state")
    print(f"an uncapturable step: make_train_epoch raised ({raised}); the state is as it was")
    return raised


def drive_epoch(cfg, device, kernels=K12, rows: int = EPOCH_ROWS, parity_batch: int = 8,
                card_line: str = "") -> dict:
    """Phase 9: the store, the batch-8 parity of the graphed epoch against
    the eager steps, and training A (``cfg``) through the graphed epoch,
    then training B (``fused_pointwise`` as well). ``kernels`` () runs on
    the CPU with the plain versions (the CPU rehearsal): the epoch is then
    the plain loop, and the training runs, whose trace, sync and timing
    checks need the card, are left out."""
    device = torch.device(device)
    store, report = epoch_store(cfg, device, rows)
    print(f"store: {report['rows']} rows, {report['bytes']} B "
          f"({report['bytes'] / 1e9:.3f} GB), card memory allocated +{report['allocated_bytes']}"
          f" B, built in {report['build_s']:.1f} s")
    out = {"store": report, "parity": epoch_parity(cfg, store, device, n=parity_batch)}
    if kernels:
        on_a = {**dict.fromkeys(K12, 1),
                **dict.fromkeys(K3 + BN_ENTRIES + BN_NHWC + ("bn_copies",), 0)}
        out["training_a"] = epoch_training(cfg, store, device, card_line, on_a)
        on_b = {**on_a, **dict.fromkeys(K3_BF16, K3_CALLS_PER_STEP)}
        out["training_b"] = epoch_training(cfg.replace(fused_pointwise=True), store, device,
                                           card_line, on_b)
        cfg_c = cfg.replace(bn_compute_dtype="compute")
        out["training_c"] = epoch_training(cfg_c, store, device, card_line,
                                           {**on_a, **bn_launches_per_step(cfg_c)})
        out["c_against_a"] = training_c_against_a(cfg, store, device, card_line)
    return out


CHAR_PATHS = ("char_session", "char_epoch")


def kernel_entries(results: dict, runs: dict, serve_launches: int) -> list:
    """The kernels line: each kernel with its launches on its own path (K1,
    K2: training A's graphed epoch, its warm-up steps and its replays, with
    the launches a replayed step from its trace; K3: the
    fused_pointwise run in bfloat16, and for K3's float32 forward and pass
    A, which a bfloat16 step never launches, phase 8's float32
    fused_pointwise step), those on every path, those on the char path
    (``launches_char``, ``replayed_per_step_char``), K1 forward's in the
    eval round by evaluation (``launches_eval``), and its measurements."""
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        path = ("train_epoch" if name in K12 else
                "train_fused_pointwise_f32" if name in F32_ONLY else "train_fused_pointwise")
        by_path = {p: r["launches"][name] for p, r in runs.items() if r["launches"][name]}
        if name == "poe_subsets_f32":
            by_path = {"serve": serve_launches, **by_path}
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": runs[path]["launches"][name], **results[name],
                 "launches_by_path": by_path}
        if name in REPLAYED:
            graphed = runs["train_epoch" if name in K12 else "train_epoch_fused_pointwise"]
            entry["replayed_per_step"] = graphed["replayed_per_step"][REPLAYED[name]]
        # the char path (phase 11): the session's endpoints and the graphed
        # epoch's warm-up and replays, and a replayed char step
        entry["launches_char"] = {p: runs[p]["launches"][name] for p in CHAR_PATHS if p in runs}
        # the eval round (phase 12): K1's forward by evaluation
        if name == "poe_subsets_f32" and "eval_round" in runs:
            entry["launches_eval"] = runs["eval_round"]["k1_by_eval"]
        if name in REPLAYED and "char_epoch" in runs:
            entry["replayed_per_step_char"] = runs["char_epoch"]["replayed_per_step"].get(
                REPLAYED[name], 0)
        kernels.append(entry)
    return kernels


# ---------------------------------------------------------------------------
# the evaluation suite: lr-eval, coherence with its classifiers, IWAE, BLEU
# ---------------------------------------------------------------------------

EVAL_ROOT = ROOT / "build" / "eval_runs"  # run and classifier directories of phase 12
EVAL_BATCHES = 2  # eval_max_batches: the whole test split of CLI_ROWS // 4 rows at batch 256
EVALS = ("lr_eval", "clf_load_or_train", "coherence", "nll", "plots")
ENCODING_EVALS = ("lr_eval", "coherence", "nll", "plots")  # the evals that run inference
EVAL_TOL = {"means": "rtol 1e-4, atol 1e-4·max|ref|", "iwae": "1e-4·max(1, |ref|)",
            "fit_lr": "2e-3·max(1, max|ref|)", "classifiers": "|Δp| ≤ 1e-4",
            "det_z_samples": "rtol 1e-4, atol 1e-4·max|ref|",
            "coherence_det_z": "|Δp| ≤ 1e-4 on equal classifier inputs"}


def eval_cli_argv(root: Path, *extra) -> list:
    """Phase 12's training CLI: the flagship config on ``testing_structured``
    (a shared class behind every modality, so the classifiers have
    something to learn) with training C's diet (``cli_argv``'s knobs) and
    depth flags only: a store of ``CLI_ROWS`` rows, ``CLI_STEPS`` steps an
    epoch, an eval round every epoch over ``EVAL_BATCHES`` test batches, one
    quick epoch of classifier training, the default ``num_imp_samples``; the
    grids written as files (``save_figure``); runs and classifiers under
    ``root``."""
    return ["--config_path", str(FLAGSHIP), "--dataset", "testing_structured",
            "--device_resident_data", "true", "--fused_text_head", "true",
            "--bn_compute_dtype", "compute", "--lr_warmup_steps", str(TRAIN_WARMUP_STEPS),
            "--synthetic_length", str(CLI_ROWS), "--steps_per_training_epoch", str(CLI_STEPS),
            "--eval_freq", "1", "--eval_max_batches", str(EVAL_BATCHES),
            "--clf_quick_epochs", "1", "--save_figure", "true", "--seed", "0",
            "--dir_experiment", str(root / "runs"), "--dir_clf", str(root / "clf"), *extra]


def eval_round_seconds(stderr: str) -> dict:
    """The eval round's line of the log → {name: seconds}."""
    m = re.search(r"eval round: ([\d.]+)s total \(([^)]*)\)", stderr)
    check(m is not None, f"no eval round in the log: {stderr[-2000:]}")
    out = {"round_s": float(m[1])}
    out.update({k: float(v) for k, v in (kv.split("=") for kv in m[2].split(", "))})
    return out


def check_plots(run: Path, cfg, epoch: int) -> int:
    """The round's grids of ``epoch``: random samples of each modality and
    the conditional grid of each subset, PNG files of the grids' sizes."""
    s, n = cfg.img_size, min(cfg.batch_size, 8)
    want = {f"random_samples/random_{m}_{epoch}.png": (8 * s, -(-n // 8) * s)
            for m in ("PA", "Lateral")}
    want[f"random_samples/random_text_{epoch}.png"] = (2 * 128, 2 * 128)
    want.update({f"cond_gen/cond_gen_{k}_{epoch}.png": (4 * s, 3 * s) for k in SUBSETS})
    for name, size in want.items():
        path = run / "plots" / name
        check(path.is_file(), f"missing plot {path}")
        check(png_size(path) == size, f"{path}: {png_size(path)}, not {size}")
    return len(want)


def eval_cli(device, card_line: str = "", extra: tuple = ()) -> dict:
    """Phase 12's CLI runs, each in a process of its own: epoch 0 of
    ``eval_cli_argv``, whose eval round trains the three classifiers and
    saves them as ``<dir>.pt``, then ``--load_run`` for epoch 1 (no
    ``--dir_clf``: it comes from the run's config.json), whose round loads
    them from those files and trains none. Each exits 0; the run's CSV
    row holds every ``lr_eval_*``, ``gen_eval_*`` and ``likelihoods_*``
    value (the likelihoods finite), TensorBoard (where the ``tensorboard``
    package imports) each evaluation's scalars and each grid at both
    epochs, and each epoch's grids are PNG files.
    ``extra`` flags: the CPU rehearsal's widths."""
    import importlib.util

    device = torch.device(device)
    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    argvs = [eval_cli_argv(EVAL_ROOT, "--end_epoch", "1", *extra)]
    out = {"processes": []}
    for i in range(2):
        if i == 1:
            (run,) = [p for p in (EVAL_ROOT / "runs").iterdir() if p.is_dir()]
            argvs.append(["--load_run", str(run), "--end_epoch", "2", *extra])
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "mopoe_mimic_tpu_torch.main", *argvs[i],
                               "--device", device.type], cwd=ROOT, capture_output=True,
                              text=True, timeout=900)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"the eval CLI (epoch {i}) exited {proc.returncode}: "
                                    f"{proc.stderr[-3000:]}")
        trained = proc.stderr.count("training classifier for modality")
        loaded = len(re.findall(r"loaded classifier for \w+ from \S+\.pt", proc.stderr))
        check((trained, loaded) == ((3, 0) if i == 0 else (0, 3)),
              f"epoch {i}: {trained} classifiers trained, {loaded} loaded from .pt")
        check(f"heavy evals CAPPED at {EVAL_BATCHES} test batches" in proc.stderr,
              f"epoch {i}: the cap is not logged")
        out["processes"].append({"epoch": i, "wall_s": wall,
                                 "eval_round_s": eval_round_seconds(proc.stderr),
                                 "classifiers_trained": trained, "classifiers_loaded": loaded})
    cfg = MopoeConfig.from_json(str(run / "config.json"))
    check(cfg.eval_lr and cfg.use_clf and cfg.calc_nll and not cfg.calc_prd,
          "the run's config does not turn the evals on")
    with open(EVAL_ROOT / "runs" / "experiments_dataframe.csv", newline="") as f:
        (row,) = list(csv.DictReader(f))
    metrics = {p: [k for k in row if k.startswith(p)] for p in
               ("lr_eval_", "gen_eval_", "likelihoods_")}
    for prefix, keys in metrics.items():
        check(keys and all(row[k] != "" for k in keys), f"the CSV row lacks {prefix}* values")
    lik = [float(row[k]) for k in metrics["likelihoods_"]]
    check(len(lik) == 7 * 4 and all(np.isfinite(lik)), f"likelihoods in the CSV: {lik}")
    check(float(row["total_epochs"]) == 1, f"CSV total_epochs {row['total_epochs']}")
    events = list((run / "logs").glob("events.out.tfevents.*"))
    has_tb = importlib.util.find_spec("tensorboard") is not None
    check(bool(events) == has_tb, f"TensorBoard events {events} (tensorboard installed: {has_tb})")
    if has_tb:  # each evaluation's scalars, and each grid at both epochs
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(str(run / "logs"), size_guidance={"images": 0, "scalars": 0})
        acc.Reload()
        tags = acc.Tags()
        for prefix in ("lr_eval/", "coherence/", "likelihoods/"):
            check(any(t.startswith(prefix) for t in tags["scalars"]), f"no {prefix}* scalars")
        check(len(tags["images"]) == 10 and all(
            sorted(e.step for e in acc.Images(t)) == [0, 1] for t in tags["images"]),
            f"TensorBoard images {tags['images']}")
    out["plots"] = sum(check_plots(run, cfg, e) for e in range(2))
    out.update(run=run, csv_values={p: len(k) for p, k in metrics.items()},
               tensorboard=has_tb, likelihood_joint=float(row["likelihoods_Lateral_PA_text_joint"]),
               bleu=float(row["gen_eval_text_gen_Lateral_PA_text_bleu"]))
    print(f"python -m mopoe_mimic_tpu_torch.main --config_path configs/flagship.json --dataset "
          f"testing_structured (training C's diet, batch {cfg.batch_size}, "
          f"{cfg.synthetic_length}-row store, {cfg.steps_per_training_epoch} steps an epoch, an "
          f"eval round each epoch over {EVAL_BATCHES} test batches): epoch 0 exit 0 in "
          f"{out['processes'][0]['wall_s']:.1f} s (3 classifiers trained), --load_run epoch 1 "
          f"exit 0 in {out['processes'][1]['wall_s']:.1f} s (3 loaded from .pt); eval rounds "
          + "; ".join(json.dumps(p["eval_round_s"]) for p in out["processes"])
          + f"; CSV values {out['csv_values']}; {out['plots']} PNG grids; TensorBoard "
          f"{'scalars and 10 grids at both epochs' if has_tb else 'not installed'} "
          f"[{card_line}]")
    return out


def eval_state(run: Path, device):
    """(experiment, state) of the run's last checkpoint on ``device``: a new
    experiment on the run's config, its directories not made, the
    classifiers' directory the run's."""
    cfg = MopoeConfig.from_json(str(run / "config.json")).replace(
        dir_clf=str(EVAL_ROOT / "clf"), dir_experiment=str(EVAL_ROOT / "round"))
    exp = Experiment(cfg, make_dirs=False, device=device)
    _, state = CheckpointManager(str(run / "checkpoints")).restore(exp.init_state())
    return exp, state


def eval_round(run: Path, device, card_line: str = "") -> dict:
    """One eval round in this process on the run's last checkpoint, each
    evaluation timed (synchronised) with its launches counted from 0: K1's
    forward in every evaluation that encodes or conditions (lr-eval,
    coherence, IWAE, the grids) and in none other, no other kernel (K1's
    backward, K2, K3) anywhere in the round; the classifiers loaded from
    their ``.pt`` files; each result checked (finite likelihoods, metrics
    and scores in [0, 1] or NaN, the grids in [0, 1]). The IWAE pass's peak
    memory; a 3-batch profile each of IWAE and coherence (batches of the
    train split: the test split has 2)."""
    import itertools

    from mopoe_mimic_tpu_torch.evaluation.clf_loader import load_or_train_classifiers
    from mopoe_mimic_tpu_torch.evaluation.coherence import test_generation
    from mopoe_mimic_tpu_torch.evaluation.likelihood import estimate_likelihoods
    from mopoe_mimic_tpu_torch.evaluation.representation import (
        test_clf_lr_all_subsets, train_clf_lr_all_subsets)
    from mopoe_mimic_tpu_torch.utils.plotting import collect_plot_arrays, render_plot_arrays

    device = torch.device(device)
    exp, state = eval_state(run, device)
    cuda = device.type == "cuda"

    def clf_rows() -> int:  # a classifier's training adds a row
        with open(EVAL_ROOT / "clf" / "clf_experiments_dataframe.csv", newline="") as f:
            return len(list(csv.DictReader(f)))

    rows_before = clf_rows()
    seconds, launches, results = {}, {}, {}

    def timed(name, fn):
        _sync(device)
        reset_launch_counts()
        t0 = time.perf_counter()
        results[name] = fn()
        _sync(device)
        seconds[name] = time.perf_counter() - t0
        launches[name] = launch_counts()

    timed("lr_eval", lambda: test_clf_lr_all_subsets(exp, state,
                                                     train_clf_lr_all_subsets(exp, state)))
    timed("clf_load_or_train", lambda: load_or_train_classifiers(exp))
    evaluator = results["clf_load_or_train"]
    timed("coherence", lambda: test_generation(exp, state, evaluator, max_batches=EVAL_BATCHES))
    peak = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    timed("nll", lambda: estimate_likelihoods(exp, state, max_batches=EVAL_BATCHES))
    if cuda:
        peak = {"before_bytes": base, "peak_bytes": torch.cuda.max_memory_allocated(device)}
    timed("plots", lambda: render_plot_arrays(exp, collect_plot_arrays(exp, state, 0), 0))

    for name in EVALS:
        k1 = launches[name]["poe_subsets_f32"]
        if cuda:
            check((k1 > 0) == (name in ENCODING_EVALS), f"eval {name}: K1 forward launched {k1}")
        others = {k: v for k, v in launches[name].items() if v and k != "poe_subsets_f32"}
        check(not others, f"eval {name} launched other kernels than K1's forward: {others}")
    check(clf_rows() == rows_before, "the round trained classifiers instead of loading them")
    check(not any(c.training for c in evaluator.classifiers.values()), "classifiers in train mode")
    for s_key, metrics in results["lr_eval"].items():
        for k, v in metrics.items():
            check(np.isnan(v) or (np.isfinite(v) and (0 <= v <= 1 or "count" in k)),
                  f"lr_eval {s_key} {k} = {v}")
    gen = results["coherence"]
    for k, v in _flat(gen).items():
        check(np.isnan(v) or 0.0 <= v <= 1.0 or k.endswith("nbr_common_words"),
              f"coherence {k} = {v}")
    check(len(gen["text_gen"]) == 7 and len(gen["cond_coherence"]) == len(exp.labels),
          f"coherence results {list(gen)}")
    lik = _flat(results["nll"])
    check(len(lik) == 28 and all(np.isfinite(v) for v in lik.values()), f"likelihoods {lik}")
    grids = results["plots"]
    check(len(grids) == 10 and all(np.isfinite(g).all() and g.min() >= 0 and g.max() <= 1
                                   for g in grids.values()), f"grids {list(grids)}")
    k1_by_eval = {n: launches[n]["poe_subsets_f32"] for n in EVALS}
    totals = {k: sum(launches[n][k] for n in EVALS) for k in launches[EVALS[0]]}
    out = {"seconds": seconds, "k1_launches": k1_by_eval, "launches": totals, "iwae_memory": peak,
           "iwae_rows": exp.cfg.num_imp_samples * exp.cfg.effective_eval_batch_size,
           "likelihood_joint": results["nll"]["Lateral_PA_text"]["joint"],
           "random_coherence": gen["random_coherence"]}
    print(f"eval round in this process ({device.type}, batch {exp.cfg.effective_eval_batch_size}, "
          f"{EVAL_BATCHES} test batches): seconds " + ", ".join(
              f"{n} {t:.3f}" for n, t in seconds.items())
          + f"; K1 forward launches by eval {k1_by_eval}, no K1 backward, K2 or K3"
          + (f"; IWAE ({out['iwae_rows']} rows a subset's decode) peak memory "
             f"{peak['peak_bytes']} B ({peak['before_bytes']} B before)" if peak else "")
          + f" [{card_line}]")
    if cuda:
        batches = list(itertools.islice(exp.eval_batches("train"), 3))
        exp.eval_batches = lambda split="test", epoch=0: iter(batches)
        for name, fn in (("nll", lambda: estimate_likelihoods(exp, state, max_batches=3)),
                         ("coherence", lambda: test_generation(exp, state, evaluator,
                                                               max_batches=3))):
            prof = device_profile(fn, 3)
            top = sorted(prof["by_name_ms"].items(), key=lambda kv: -kv[1])[:6]
            out[f"profile_{name}"] = {"wall_ms": prof["wall_ms"], "device_busy_ms": prof["busy_ms"],
                                      "idle_pct": prof["idle_pct"], "device_ops": prof["ops"],
                                      "top_ops_ms": {n[:80]: t for n, t in top}}
            print(f"{name} 3-batch profile (batch {exp.cfg.effective_eval_batch_size}): wall "
                  f"{prof['wall_ms']:.3f} ms a batch, device busy {prof['busy_ms']} ms, idle "
                  f"{prof['idle_pct']}%, {prof['ops']:.0f} device ops; top: "
                  + "; ".join(f"{n[:60]} {t:.3f} ms" for n, t in top) + f" [{card_line}]")
    return out


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = float(v)
    return out


def eval_gpu_against_cpu(run: Path, device, n: int = 8) -> dict:
    """Each evaluation's device work on the card against the CPU, float32,
    on the run's last weights and its trained classifiers, batch ``n`` of
    the test split: the subset means (``MMVae.inference``: K1 on the card);
    IWAE with one injected eps [K·n, D] a subset, every subset × modality and
    the joint; ``_fit_lr_batch`` on one seeded x, y (21 problems × 500
    samples × the latent width); each classifier's eval-mode probabilities
    on the batch; the det-z (eps = 0) conditional samples themselves, and
    their probabilities under the classifiers. Tolerances: ``EVAL_TOL``.

    The word-text classifier reads the argmax of the generated vocabulary
    probabilities, and an argmax flips between two devices wherever two
    tokens are tied to within the samples' rounding. A flipped token is a
    different classifier input, so its row's probabilities are not held to
    the CPU's; ``det_z_flips`` counts such tokens and rows, and the largest
    gap between the two tokens' CPU probabilities (at most twice the
    samples' error). Every row, flipped or not, is also held to the CPU with
    the card's text classifier reading the CPU's token ids."""
    from mopoe_mimic_tpu_torch.evaluation.clf_loader import clf_weights_path
    from mopoe_mimic_tpu_torch.evaluation.coherence import CoherenceEvaluator
    from mopoe_mimic_tpu_torch.evaluation.likelihood import make_likelihood_fn
    from mopoe_mimic_tpu_torch.evaluation.representation import _fit_lr_batch
    from mopoe_mimic_tpu_torch.train.clf_trainer import make_classifier
    from mopoe_mimic_tpu_torch.train.step import eval_mode, to_device

    device = torch.device(device)
    cfg = MopoeConfig.from_json(str(run / "config.json")).replace(
        batch_size=n, compute_dtype="float32", dir_clf=str(EVAL_ROOT / "clf"))
    _, payload = CheckpointManager(str(run / "checkpoints")).read()
    ds = Experiment(cfg, make_dirs=False, device="cpu").dataset_test
    host = {k: np.asarray(v[:n]) for k, v in ds.arrays.items()}
    host = {k: np.ascontiguousarray(v.transpose(0, 3, 1, 2)) if v.ndim == 4 else v
            for k, v in host.items()}
    keys = list(F.subset_powerset(cfg.modality_names))
    rng = np.random.default_rng(21)
    eps = {s: torch.from_numpy(rng.normal(size=(cfg.num_imp_samples * n, cfg.class_dim))
                               .astype(np.float32)) for s in keys}
    lr_x = rng.normal(size=(21, 500, cfg.class_dim)).astype(np.float32)
    lr_y = (rng.random((21, 500)) < 1 / (1 + np.exp(-lr_x[..., 0] * 2))).astype(np.float32)
    sides, evaluators = {}, {}
    reset_launch_counts()
    for dev in (device, torch.device("cpu")):
        torch.manual_seed(0)
        model = MMVae(cfg)
        model.load_state_dict(payload["model"])
        model.to(dev)
        classifiers = {}
        for m in cfg.modality_names:
            clf = make_classifier(cfg, m, 3)
            clf.load_state_dict(torch.load(clf_weights_path(cfg, m), map_location="cpu",
                                           weights_only=True))
            classifiers[m] = clf.to(dev).eval()
        ev = evaluators[dev.type] = CoherenceEvaluator(cfg, classifiers)
        batch = to_device(host, next(model.parameters()))
        with eval_mode(cfg, model):
            lat = model.inference(batch)
            lik = make_likelihood_fn(cfg, model, keys)(
                batch, eps={s: e.to(dev) for s, e in eps.items()})
            cond = model.cond_generation(lat["subsets"], eps=0.0)
        w, b = _fit_lr_batch(torch.from_numpy(lr_x).to(dev), torch.from_numpy(lr_y).to(dev))
        sides[dev.type] = {
            "means": {s: [t.cpu().numpy() for t in lat["subsets"][s]] for s in keys},
            "iwae": {s: {m: float(v) for m, v in d.items()} for s, d in lik.items()},
            "fit_lr": [w.cpu().numpy(), b.cpu().numpy()],
            "classifiers": {m: ev.predict(m, batch[m]).cpu().numpy() for m in cfg.modality_names},
            "det_z": {s: {m: t.cpu().numpy() for m, t in g.items()} for s, g in cond.items()},
            "coherence_det_z": {s: {m: ev.predict(m, g[m]).cpu().numpy()
                                    for m in cfg.modality_names} for s, g in cond.items()}}
    k1 = launch_counts()["poe_subsets_f32"]
    if device.type == "cuda":
        check(k1 > 0, "the GPU side of the eval comparison did not launch K1")
    got, ref = sides[device.type], sides["cpu"]
    err = {}
    worst = 0.0
    for s in keys:
        for g, r in zip(got["means"][s], ref["means"][s]):
            scale = float(np.abs(r).max())
            e = np.abs(g - r)
            check(bool((e <= 1e-4 * np.abs(r) + 1e-4 * scale).all()),
                  f"subset means {s}: max |Δ| {e.max():.3e}")
            worst = max(worst, float(e.max()) / max(scale, 1e-30))
    err["means"] = worst
    worst = 0.0
    for s in keys:
        for m, r in ref["iwae"][s].items():
            e = abs(got["iwae"][s][m] - r) / max(1.0, abs(r))
            check(np.isfinite(r) and e <= 1e-4, f"IWAE {s} {m}: {got['iwae'][s][m]} vs {r}")
            worst = max(worst, e)
    err["iwae"] = worst
    worst = 0.0
    for g, r in zip(got["fit_lr"], ref["fit_lr"]):
        e = float(np.abs(g - r).max()) / max(1.0, float(np.abs(r).max()))
        check(e <= 2e-3, f"_fit_lr_batch: {e:.3e}")
        worst = max(worst, e)
    err["fit_lr"] = worst
    err["classifiers"] = max(float(np.abs(got["classifiers"][m] - r).max())
                             for m, r in ref["classifiers"].items())
    check(err["classifiers"] <= 1e-4, f"classifiers: max |Δp| {err['classifiers']:.3e}")
    err["det_z_samples"], flips = det_z_sample_errors(cfg, got["det_z"], ref["det_z"])
    worst = 0.0
    for s, d in ref["coherence_det_z"].items():
        for m, r in d.items():
            same = flips["same_rows"][s][m]
            if same.any():
                worst = max(worst, float(np.abs(got["coherence_det_z"][s][m][same] - r[same]).max()))
            if m in flips["ref_ids"]:  # every row, on the CPU's token ids
                on_ref = evaluators[device.type].predict(m, torch.from_numpy(flips["ref_ids"][m][s]))
                worst = max(worst, float(np.abs(on_ref.cpu().numpy() - r).max()))
    err["coherence_det_z"] = worst
    flips = {k: v for k, v in flips.items() if k not in ("same_rows", "ref_ids")}
    print(f"evaluation, det-z word-text argmax flips {device.type} against the CPU: {flips}")
    for s in keys:
        for m, r in ref["det_z"][s].items():
            g = got["det_z"][s][m]
            check(bool((np.abs(g - r) <= 1e-4 * np.abs(r) + 1e-4 * float(np.abs(r).max())).all()),
                  f"det-z samples {s} {m}: max |Δ| {np.abs(g - r).max():.3e}")
    check(err["coherence_det_z"] <= 1e-4, f"det-z coherence: max |Δp| {err['coherence_det_z']:.3e}")
    print(f"evaluation, {device.type} against the CPU (float32, TF32 off, batch {n}, the run's "
          "weights and classifiers): " + ", ".join(f"{k} {v:.3e} (bound {EVAL_TOL[k]})"
                                                   for k, v in err.items())
          + f"; K1 forward launches {k1}")
    return {"max_err": err, "tolerance": EVAL_TOL, "k1_launches": k1, "det_z_flips": flips}


def det_z_sample_errors(cfg, got: dict, ref: dict) -> tuple:
    """(the largest error of the det-z samples {subset: {modality: array}},
    relative to each array's max|ref|; the word-text argmax flips): the flip
    record counts the tokens and the rows whose argmax differs, the largest
    gap between the CPU's probabilities of its own and the other token,
    ``same_rows`` {subset: {modality: [B] bool}} for the rows whose
    classifier input is equal on both sides, and ``ref_ids`` {modality:
    {subset: the CPU's token ids}}."""
    worst = 0.0
    flips = {"tokens": 0, "rows": 0, "max_gap": 0.0, "same_rows": {}, "ref_ids": {}}
    for s, d in ref.items():
        flips["same_rows"][s] = {}
        for m, r in d.items():
            g = got[s][m]
            worst = max(worst, float(np.abs(g - r).max()) / max(float(np.abs(r).max()), 1e-30))
            same = np.ones(r.shape[0], dtype=bool)
            if m == "text" and cfg.text_encoding == "word" and r.ndim == 3:
                ids_r, ids_g = r.argmax(-1), g.argmax(-1)
                flipped = ids_r != ids_g
                same = ~flipped.any(axis=1)
                flips["tokens"] += int(flipped.sum())
                flips["rows"] += int((~same).sum())
                if flipped.any():
                    gap = (np.take_along_axis(r, ids_r[..., None], -1)
                           - np.take_along_axis(r, ids_g[..., None], -1))[..., 0][flipped]
                    flips["max_gap"] = max(flips["max_gap"], float(gap.max()))
                flips["ref_ids"].setdefault(m, {})[s] = ids_r.astype(np.int32)
            flips["same_rows"][s][m] = same
    return worst, flips


def evaluation(device, card_line: str = "", extra: tuple = ()) -> dict:
    """Phase 12: the evaluation suite at the flagship's full width
    (``eval_cli``, ``eval_round``, ``eval_gpu_against_cpu``). ``extra``
    flags: the CPU rehearsal's widths."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the CLIs' own processes share the card
    out = {"cli": eval_cli(device, card_line, extra)}
    run = out["cli"].pop("run")
    out["round"] = eval_round(run, device, card_line)
    out["gpu_against_cpu"] = eval_gpu_against_cpu(run, device)
    out["cli"]["run"] = run.name
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    # forward convs and transposed convs may pick algorithms that sum with
    # atomics; a seed must give the same samples twice
    torch.backends.cudnn.deterministic = True
    card_line = card()
    print(f"card: {card_line}; max SM clock {sm_max_clock_hz() / 1e6:.0f} MHz; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {lib._name} in {time.perf_counter() - t0:.1f} s")
    report = ptxas_report()
    k1_regs = k1_resources(report)
    sass = kernel_resources(lib._name, report)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {**k1_entries(device, card_line), **k2_against_plain(device, card_line),
               **k3_against_plain(device),
               **k3_stats_against_plain(device, card_line)}
    print(json.dumps({"batchnorm": bn_against_aten(device, card_line)}))
    for name in TENSOR_CORE_KERNELS:  # K2's entries are named by the function, K3's by kernel
        results[name if name in results else name.removesuffix("_tc")]["sass"] = sass[name]
    for name, glob in K1_GLOBALS.items():
        results[name]["ptxas"] = {k: v for k, v in k1_regs.items() if glob in k}

    flagship = MopoeConfig.from_json(str(FLAGSHIP))
    sd = random_state_dict(flagship)
    reset_launch_counts()
    per_dtype = {}
    for dtype in ("float32", "bfloat16"):
        before = cuda_fusion.LAUNCHES["poe_subsets_f32"]
        sess = InferenceSession(flagship.replace(compute_dtype=dtype), state_dict=sd,
                                device=device)
        outs = drive_slice(sess)
        check_slice(sess.cfg, outs)
        per_dtype[dtype] = cuda_fusion.LAUNCHES["poe_subsets_f32"] - before
        check(per_dtype[dtype] > 0, f"slice in {dtype} did not launch K1")
        enc = outs["encode"]["subsets"]["Lateral_PA_text"]
        print(f"slice {dtype}: encode 40, generate 16 ×2, cond_generate 8 ×2 ok; "
              f"K1 launches {per_dtype[dtype]}; max|mu| {np.abs(enc[0]).max():.3g}, "
              f"max|logvar| {np.abs(enc[1]).max():.3g}")
    serve_launches = cuda_fusion.LAUNCHES["poe_subsets_f32"]

    gpu_against_cpu(flagship, sd, device)
    endpoint_timings(InferenceSession(flagship, state_dict=sd, device=device), card_line)

    # lr 5e-4 with the repo's warmup ramp: without it this architecture
    # diverges within two steps on noise inputs (docs/STABILITY.md)
    train_cfg = flagship.replace(fused_text_head=True, compute_dtype="bfloat16",
                                 lr_warmup_steps=TRAIN_WARMUP_STEPS)
    runs = {}
    for path, cfg, launched, per_step in (
            ("train", train_cfg, K12, {**K2_PER_STEP, **dict.fromkeys(K3, 0)}),
            ("train_fused_pointwise", train_cfg.replace(fused_pointwise=True), K12 + K3_BF16,
             {**K2_PER_STEP, **dict.fromkeys(K3_BF16, K3_CALLS_PER_STEP),
              **dict.fromkeys(F32_ONLY, 0)})):
        knobs = "fused_text_head" + (", fused_pointwise" if cfg.fused_pointwise else "")
        run = runs[path] = drive_training(cfg, device, launched, per_step)
        terms = {k: round(float(v), 4) for k, v in loss_terms(run["metrics"]).items()}
        print(f"train slice (flagship, {knobs}, batch {cfg.batch_size}, bf16): 13 steps ok; "
              f"launches {run['launches']}; params moved {run['params_moved']}; "
              f"last step {terms}, grad_norm {float(run['metrics']['grad_norm']):.4g}")
        print(f"p50 train step (batch {cfg.batch_size}, bf16, {knobs}, 10 steps after 3 "
              f"warm-up): {run['p50_ms']:.3f} ms, {run['samples_per_s']:.1f} samples/s "
              f"[{card_line}]")
        print(device_idle_share(lambda: run["step"](run["state"], run["batch"])))
        if path == "train":
            run["syncs"] = check_latent_block_syncs(run)
    turns = steps_in_turns(runs)
    print("p50 train step in turns (A B B A, 5 steps a turn, after the runs above): "
          + ", ".join(f"{p} {t:.3f} ms" for p, t in turns.items()) + f" [{card_line}]")
    k3_totals, k3_shapes = k3_step_bounds(runs["train_fused_pointwise"])
    print(f"K3 per fused_pointwise step, Σ over its {K3_CALLS_PER_STEP} blocks of the bound on "
          "each launch's inputs: " + ", ".join(f"{n} {t:.4f} ms" for n, t in k3_totals.items()))
    k3_block_profile(k3_shapes, device, card_line)
    for run in runs.values():
        del run["state"], run["batch"], run["step"]
    gpu_step_against_cpu(flagship.replace(fused_text_head=True), device)
    reset_launch_counts()
    gpu_step_against_cpu(flagship.replace(fused_text_head=True, fused_pointwise=True), device,
                         tuple(KERNELS))
    runs["train_fused_pointwise_f32"] = {"launches": launch_counts()}

    # the epoch path: training A through the card-resident store and the
    # graphed epoch (the main path), after the float32 parity against eager
    epoch = drive_epoch(train_cfg, device, card_line=card_line)
    runs["train_epoch"] = epoch["training_a"]
    runs["train_epoch_fused_pointwise"] = epoch["training_b"]
    print(json.dumps({"epoch_training": epoch}))

    # the training CLI, the main path since it was ported
    direct = statistics.mean(epoch["c_against_a"]["C"]["ms_per_step"])
    cli = cli_training(device, card_line, direct)
    runs["cli"] = {"launches": cli["launches"]}

    # char-1024 text and serving from a run directory: the training and
    # serve CLIs, the session on the run, char C against word C
    word_run = next(p for p in (CLI_ROOT / "process").iterdir() if p.is_dir())
    char = char_and_serving(device, card_line, word_run)
    runs["char_session"] = {"launches": char["session"]["launches"]}
    runs["char_epoch"] = {k: char["graphed"]["char"][k] for k in ("launches",
                                                                  "replayed_per_step")}
    print(json.dumps({"char_and_serving": char}))

    # the evaluation suite at the flagship's full width: the training CLI
    # with its eval rounds, one round in this process, GPU against CPU
    evaluated = evaluation(device, card_line)
    runs["eval_round"] = {"launches": evaluated["round"]["launches"],
                          "k1_by_eval": evaluated["round"]["k1_launches"]}
    print(json.dumps({"evaluation": evaluated}))

    cli["autotune"] = cli_autotune(device, card_line)
    print(json.dumps({"cli_training": cli}))

    epoch_capture_raises(train_cfg, device)

    print(json.dumps({"kernels": kernel_entries(results, runs, serve_launches)}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
