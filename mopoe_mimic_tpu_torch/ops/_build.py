"""Build the package's CUDA kernels at first use and load them with ctypes.

All ``csrc/*.cu`` sources compile with ``nvcc``, one process per source,
all started at once, and link into one shared library with a plain C
interface (no PyTorch headers: seconds to build, where
``torch.utils.cpp_extension.load`` takes minutes). The library goes to
``build/kernels/`` beside the package, keyed by a hash of the sources,
the headers ``csrc/*.cuh`` they include and the flags, so an edited
kernel never loads a stale binary; ptxas's report of each kernel's
registers and spills goes beside it. A failed build raises with nvcc's
output; nothing falls back.

Each wrapper module counts its launches in a ``LAUNCHES`` dict made by
``launch_counts``. A launch made while a CUDA graph captures is not run
then: ``uncounted`` takes a capture's launches back out of the counts and
returns them, and ``add_launches`` counts them once a replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from mopoe_mimic_tpu_torch.utils import profiling

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

MAX_EXPERTS = 8
MAX_SUBSETS = 255


class SubsetMasks(ctypes.Structure):
    """Mirror of ``struct SubsetMasks`` in csrc/poe_subsets.cu (by pointer)."""

    _fields_ = [("n_subsets", ctypes.c_int),
                ("members", ctypes.c_ubyte * MAX_SUBSETS)]


class Experts(ctypes.Structure):
    """Mirror of ``struct Experts`` in csrc/poe_subsets.cu (by pointer): each
    expert's mu and logvar pointer and row stride (in floats)."""

    _fields_ = [("mu", ctypes.c_void_p * MAX_EXPERTS),
                ("lv", ctypes.c_void_p * MAX_EXPERTS),
                ("mu_row", ctypes.c_longlong * MAX_EXPERTS),
                ("lv_row", ctypes.c_longlong * MAX_EXPERTS)]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources, their headers and the
    flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmopoe_kernels_{digest.hexdigest()[:16]}.so"


def _run(procs) -> str:
    """Wait for every (command, process); raise with nvcc's output on
    failure, else return what the processes wrote to stderr."""
    failed, logs = [], []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        logs.append(err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def build_log_path() -> Path:
    """ptxas's report (``-Xptxas -v``: registers, spills) of the library's build."""
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    try:
        compile_ = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c"]
        log = _run([_start([*compile_, "-o", str(obj), str(src)])
                    for src, obj in zip(_sources(), objects)])
        _run([_start([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)])])
        build_log_path().write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature
    (the span ``kernels.load``, whose ``built`` says whether nvcc ran)."""
    with profiling.span("kernels.load", built=not library_path().exists()):
        return _declare(ctypes.CDLL(str(build())))


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with every entry point's signature declared."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    experts, masks = ctypes.POINTER(Experts), ctypes.POINTER(SubsetMasks)
    signatures = {
        # experts, mu_out, lv_out, M, B, D, masks (None: the power set), prior, prior_t, stream
        "poe_subsets_f32": [experts] + [ptr] * 2 + [i32] * 3 + [masks, i32, f32, ptr],
        # experts, dmu_s, dlv_s, dmu, dlv, M, B, D, masks, prior, prior_t, stream
        "poe_subsets_bwd_f32": [experts] + [ptr] * 4 + [i32] * 3 + [masks, i32, f32, ptr],
        # h, W, b, targets, lp, lse, R, C, V, dtype, stream
        "texthead_fwd": [ptr] * 6 + [i32] * 4 + [ptr],
        # h, W, b, targets, lse, g, dh, R, C, V, dtype, stream
        "texthead_bwd_dh": [ptr] * 7 + [i32] * 4 + [ptr],
        # R, C, V (no launch)
        "texthead_bwd_dw_splits": [i32] * 3,
        # h, W, b, targets, lse, g, dW (or partials), db (or partials), R, C, V, splits,
        # dtype, stream
        "texthead_bwd_dw": [ptr] * 8 + [i32] * 5 + [ptr],
        # part_dw, part_db, dW, db, splits, C, V, stream
        "texthead_bwd_dw_finalize": [ptr] * 4 + [i32] * 3 + [ptr],
        # x, gamma, beta, mean, inv, W, cb, y, B, C, Co, S, x_dtype, w_dtype, stream
        "pointwise_fwd": [ptr] * 8 + [i32] * 6 + [ptr],
        # x, gamma, beta, mean, inv, W, cb, y, B, C, Co, S, x_dtype, stream
        "pointwise_fwd_tc": [ptr] * 8 + [i32] * 5 + [ptr],
        # x, gamma, beta, mean, inv, W, dy, part_dw, part_dcb, part_dg, part_db,
        # B, C, Co, S, chunk_rows, x_dtype, w_dtype, stream
        "pointwise_bwd_reduce": [ptr] * 11 + [i32] * 7 + [ptr],
        # x, gamma, beta, mean, inv, W, dy, part_dw, part_dcb, part_dg, part_db,
        # B, C, Co, S, chunk_rows, x_dtype, stream
        "pointwise_bwd_reduce_tc": [ptr] * 11 + [i32] * 6 + [ptr],
        # part_dw, part_dcb, part_dg, part_db, dW, dcb, dg, db, C, Co, chunks, o_tiles, stream
        "pointwise_bwd_finalize": [ptr] * 8 + [i32] * 4 + [ptr],
        # x, gamma, beta, mean, inv, W, dy, dg, db, dx, B, C, Co, S, x_dtype, w_dtype, stream
        "pointwise_bwd_dx": [ptr] * 10 + [i32] * 6 + [ptr],
        # x, gamma, beta, mean, inv, W, dy, dg, db, dx, B, C, Co, S, rows, x_dtype, stream
        "pointwise_bwd_dx_tc": [ptr] * 10 + [i32] * 6 + [ptr],
        # x, part_mean, part_m2, B, C, S, b_per_chunk, x_dtype, stream
        "pointwise_stats": [ptr] * 3 + [i32] * 5 + [ptr],
        # part_mean, part_m2, mean, var, inv, running_mean, running_var, B, C, S,
        # b_per_chunk, eps, m, one_minus_m, unbias, stream
        "pointwise_stats_finalize": [ptr] * 7 + [i32] * 4 + [f32] * 4 + [ptr],
        # x, weight, bias, running_mean, running_var, y, save_mean, save_invstd, part,
        # N, C, S, vec, tpc, b_per_chunk, fused, eps, m, one_minus_m, unbias, stream
        "bn_fwd": [ptr] * 9 + [i32] * 7 + [f32] * 4 + [ptr],
        # x, dy, weight, save_mean, save_invstd, dx, dweight, dbias, part,
        # N, C, S, vec, tpc, b_per_chunk, fused, stream
        "bn_bwd": [ptr] * 9 + [i32] * 7 + [ptr],
        # x, weight, bias, running_mean, running_var, y, save_mean, save_invstd, part,
        # R, C, vec, cols, rows_per_chunk, chunks, fused, eps, m, one_minus_m, unbias, stream
        "bn_fwd_nhwc": [ptr] * 9 + [i32] * 7 + [f32] * 4 + [ptr],
        # x, dy, weight, save_mean, save_invstd, dx, dweight, dbias, part,
        # R, C, vec, cols, rows_per_chunk, chunks, fused, stream
        "bn_bwd_nhwc": [ptr] * 9 + [i32] * 7 + [ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_CURRENT = contextlib.nullcontext()


def on_device(device):
    """``torch.cuda.device(device)`` where it is not the current device
    already; else nothing to enter (the context manager costs microseconds a
    call). The current device is read from the runtime directly, as
    ``torch.cuda.current_device`` does after its initialisation check: the
    tensors on ``device`` have initialised CUDA already."""
    if device.index == torch._C._cuda_getDevice():
        return _CURRENT
    return torch.cuda.device(device)


_LAUNCH_COUNTS: List[Dict[str, int]] = []

Launches = List[Tuple[Dict[str, int], str, int]]


def launch_counts(*names: str) -> Dict[str, int]:
    """A module's ``LAUNCHES``: a count for each entry point it launches,
    known to ``uncounted``."""
    counts = dict.fromkeys(names, 0)
    _LAUNCH_COUNTS.append(counts)
    return counts


def uncounted(capture: Callable[[], None]) -> Launches:
    """Run ``capture`` (a CUDA graph's capture); the launches it counted,
    as (counts, name, launches), taken back out of the counts."""
    before = [dict(counts) for counts in _LAUNCH_COUNTS]
    capture()
    out = []
    for i, counts in enumerate(_LAUNCH_COUNTS):
        was = before[i] if i < len(before) else dict.fromkeys(counts, 0)
        for name, n in counts.items():
            if n != was[name]:
                out.append((counts, name, n - was[name]))
                counts[name] = was[name]
    return out


def add_launches(launches: Launches) -> None:
    """Count a replay of a graph whose capture ``uncounted`` returned
    ``launches``."""
    for counts, name, n in launches:
        counts[name] += n


def launch(counts: Dict[str, int], name: str, *args) -> None:
    """Call the entry point ``name`` on the current stream of the current
    device, raise with its cudaError if it returns one, else add one to
    ``counts[name]``. The stream is read as a raw pointer
    (``torch.cuda.current_stream()`` builds a Python object each call, some
    microseconds of host time)."""
    stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
    err = getattr(load_library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    counts[name] += 1
