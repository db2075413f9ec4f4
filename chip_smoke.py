#!/usr/bin/env python3
"""Drive the PyTorch port's serving path once on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device; exits non-zero, printing no result, without one.
Imports the port (``mopoe_mimic_tpu_torch``), torch and numpy only. Phases,
any failure of which exits non-zero:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: the CUDA kernels from ``mopoe_mimic_tpu_torch/csrc`` into
     ``build/kernels/``;
  3. K1 against its plain PyTorch version on the card, M ∈ {1, 2, 3},
     B ∈ {1, 5, 8, 32, 128, 256}, D = 64, with and without the prior
     expert: max |Δ| ≤ 1e-6·max(1, |ref|); then both timed at B = 128, 256;
  4. the slice at the flagship configuration's full width
     (configs/flagship.json: 128 px, word text len 128, vocab 3517,
     DIM 64, class_dim 64; random weights from seed 0, randomised BN
     running statistics): ``encode`` of 40 rows, ``generate`` of 16 twice
     (identical), ``cond_generate`` of 8 rows full and compact, in float32
     and in bfloat16; outputs checked, K1's launch count > 0;
  5. the GPU session's ``encode`` (kernel) against a CPU session's (plain)
     on the same float32 weights with TF32 off: rtol 1e-4, atol
     1e-4·max|ref|, every subset and the joint;
  6. p50 latency of each endpoint at buckets 8 and 128.

The last lines are a JSON object of the kernels, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mopoe_mimic_tpu_torch.config import MopoeConfig
from mopoe_mimic_tpu_torch.models.mmvae import MMVae
from mopoe_mimic_tpu_torch.ops import _build, cuda_fusion
from mopoe_mimic_tpu_torch.ops import fusion as F
from mopoe_mimic_tpu_torch.serve import InferenceSession

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "configs" / "flagship.json"
K1_SOURCE = "mopoe_mimic_tpu_torch/csrc/poe_subsets.cu"
K1_REPLACES = "mopoe_mimic_tpu/ops/pallas_fusion.py:42"
NAMES = ("PA", "Lateral", "text")
SUBSETS = {"PA", "Lateral", "text", "Lateral_PA", "PA_text", "Lateral_text", "Lateral_PA_text"}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


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


def k1_against_plain(device: torch.device) -> dict:
    rng = np.random.default_rng(0)
    worst = 0.0
    for m in (1, 2, 3):
        mask = F.subset_mask_matrix(NAMES[:m])
        for b in (1, 5, 8, 32, 128, 256):
            mus = torch.from_numpy(rng.normal(size=(m, b, 64)).astype(np.float32)).to(device)
            lvs = torch.from_numpy(rng.normal(size=(m, b, 64)).astype(np.float32)).to(device)
            for prior in (False, True):
                got = cuda_fusion.poe_subsets_cuda(mus, lvs, mask, prior_expert=prior)
                ref = F.poe_subsets(mus, lvs, mask, prior_expert=prior)
                torch.cuda.synchronize()
                for g, r, what in zip(got, ref, ("mu", "logvar")):
                    check(g.shape == r.shape, f"K1 shape {tuple(g.shape)} != {tuple(r.shape)}")
                    err = (g - r).abs()
                    bound = 1e-6 * torch.clamp(r.abs(), min=1.0)
                    check(bool((err <= bound).all()),
                          f"K1 {what} M={m} B={b} prior={prior}: max |Δ| {err.max().item():.3e}")
                    worst = max(worst, err.max().item())
    print(f"K1 vs plain: max |Δ| {worst:.3e} over M∈{{1,2,3}}, B∈{{1,5,8,32,128,256}}, "
          "D=64, prior both ways (bound 1e-6·max(1,|ref|))")

    times = {}
    mask = F.subset_mask_matrix(NAMES)
    for b in (128, 256):
        mus = torch.randn((3, b, 64), device=device)
        lvs = torch.randn((3, b, 64), device=device)
        k_ms = cuda_ms(lambda: cuda_fusion.poe_subsets_cuda(mus, lvs, mask))
        p_ms = cuda_ms(lambda: F.poe_subsets(mus, lvs, mask))
        times[b] = (k_ms, p_ms)
        print(f"K1 time M=3 B={b} D=64: kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us "
              "(median of 100 calls, CUDA events)")
    return {"max_abs_err": worst, "ms": times[128][0], "plain_ms": times[128][1]}


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


def request(cfg, n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    s, c = cfg.img_size, cfg.image_channels
    return {
        "PA": rng.random((n, s, s, c), dtype=np.float32),
        "Lateral": rng.random((n, s, s, c), dtype=np.float32),
        "text": rng.integers(0, cfg.vocab_size, (n, cfg.len_sequence)).astype(np.int32),
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
    s, c, L, V, D = cfg.img_size, cfg.image_channels, cfg.len_sequence, cfg.vocab_size, cfg.class_dim
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


def endpoint_timings(sess: InferenceSession, card_line: str) -> None:
    for bucket in (8, 128):
        batch = request(sess.cfg, bucket, seed=13)
        for name, fn in (
            ("encode", lambda: sess.encode(batch)),
            ("generate compact", lambda: sess.generate(bucket, seed=3, compact=True)),
            ("cond_generate compact", lambda: sess.cond_generate(batch, seed=3, compact=True)),
        ):
            print(f"p50 {name} bucket {bucket} ({sess.cfg.compute_dtype}): "
                  f"{p50_ms(fn):.3f} ms [{card_line}]")


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
    print(f"card: {card_line}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {lib._name} in {time.perf_counter() - t0:.1f} s")

    k1 = k1_against_plain(device)

    flagship = MopoeConfig.from_json(str(FLAGSHIP))
    sd = random_state_dict(flagship)
    cuda_fusion.LAUNCHES = 0
    per_dtype = {}
    for dtype in ("float32", "bfloat16"):
        before = cuda_fusion.LAUNCHES
        sess = InferenceSession(flagship.replace(compute_dtype=dtype), state_dict=sd,
                                device=device)
        outs = drive_slice(sess)
        check_slice(sess.cfg, outs)
        per_dtype[dtype] = cuda_fusion.LAUNCHES - before
        check(per_dtype[dtype] > 0, f"slice in {dtype} did not launch K1")
        enc = outs["encode"]["subsets"]["Lateral_PA_text"]
        print(f"slice {dtype}: encode 40, generate 16 ×2, cond_generate 8 ×2 ok; "
              f"K1 launches {per_dtype[dtype]}; max|mu| {np.abs(enc[0]).max():.3g}, "
              f"max|logvar| {np.abs(enc[1]).max():.3g}")
    launches = cuda_fusion.LAUNCHES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu_against_cpu(flagship, sd, device)

    endpoint_timings(InferenceSession(flagship, state_dict=sd, device=device), card_line)

    print(json.dumps({"kernels": [{
        "name": "poe_subsets_f32", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
    }]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
