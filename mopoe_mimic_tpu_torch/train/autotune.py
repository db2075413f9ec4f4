"""Batch size against the card's memory (mopoe_mimic_tpu/train/autotune.py;
the reference's CUDA-OOM retries, mimic/main_mimic.py:116-121 ×0.8).

``autotune_batch_size`` doubles the batch while one train step at it
fits in a fraction of the card's memory: ``step_memory_bytes`` runs that
step on the card and reads the allocator's peak (a step's real peak; the
JAX package reads XLA's plan instead, without running). ``is_oom_error``
tells the CLI's backoff (``main.py``) a memory exhaustion from other
failures.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional, Union

import torch

from mopoe_mimic_tpu_torch.utils.exceptions import DeviceOutOfMemory
from mopoe_mimic_tpu_torch.utils.logger import log

_OOM_MARKERS = ("CUDA out of memory", "out of memory", "Out of memory")


def is_oom_error(e: BaseException) -> bool:
    """True when an exception is a memory exhaustion of the card or host."""
    if isinstance(e, (torch.cuda.OutOfMemoryError, DeviceOutOfMemory, MemoryError)):
        return True
    return any(m in str(e) for m in _OOM_MARKERS)


def device_memory_bytes(device: Union[str, torch.device] = "cuda") -> Optional[int]:
    """The card's memory (``torch.cuda.mem_get_info``'s total, else the
    device's ``total_memory``); None on the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    try:
        return int(torch.cuda.mem_get_info(device)[1])
    except RuntimeError:
        return int(torch.cuda.get_device_properties(device).total_memory)


def free_device_memory() -> None:
    """Drop what the allocator caches (after the objects that held it are
    gone), so that a retry starts from the card's free memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def step_memory_bytes(cfg, device: Union[str, torch.device] = "cuda") -> int:
    """The allocator's peak over one train step at ``cfg.batch_size`` on the
    card (the state and a synthetic batch included); a step that does not
    fit raises ``DeviceOutOfMemory``."""
    from mopoe_mimic_tpu_torch.data.loader import BatchLoader
    from mopoe_mimic_tpu_torch.data.synthetic import SyntheticMimic
    from mopoe_mimic_tpu_torch.train.state import create_train_state
    from mopoe_mimic_tpu_torch.train.step import make_train_step

    device = torch.device(device)
    batch, _ = next(iter(BatchLoader(SyntheticMimic(cfg, seed=0, length=cfg.batch_size),
                                     cfg.batch_size, shuffle=False)))
    free_device_memory()
    torch.cuda.reset_peak_memory_stats(device)
    oom = None
    try:
        state = create_train_state(cfg, device, seed=0)
        make_train_step(cfg)(state, batch)
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    except torch.cuda.OutOfMemoryError as e:
        oom = str(e).splitlines()[0]
    # raised here, outside the handler, so that no traceback keeps the
    # step's tensors alive while the cache is emptied
    state = None
    free_device_memory()
    if oom is not None:
        raise DeviceOutOfMemory(f"batch {cfg.batch_size}: {oom}")
    return int(peak)


def autotune_batch_size(cfg, max_batch: int = 4096, budget_fraction: float = 0.9,
                        memory_bytes: Optional[int] = None,
                        probe_fn: Optional[Callable] = None,
                        device: Union[str, torch.device] = "cuda") -> int:
    """The largest power-of-two multiple of ``cfg.batch_size`` whose train
    step fits in ``budget_fraction`` of the card's memory; ``cfg.batch_size``
    where the device reports no memory (the CPU).

    ``probe_fn(cfg) -> bytes``: the step's peak (``step_memory_bytes`` on
    ``device`` by default; injectable for tests).
    """
    probe_fn = probe_fn or (lambda c: step_memory_bytes(c, device))
    memory_bytes = memory_bytes if memory_bytes is not None else device_memory_bytes(device)
    if not memory_bytes:
        log.info(f"autotune: device reports no memory capacity; keeping "
                 f"batch_size={cfg.batch_size}")
        return cfg.batch_size
    budget = budget_fraction * memory_bytes

    best = None
    bs = cfg.batch_size
    while bs <= max_batch:
        try:
            peak = probe_fn(cfg.replace(batch_size=bs))
        except Exception as e:
            if is_oom_error(e):
                log.info(f"autotune: batch {bs} does not fit (out of memory)")
                break
            raise
        log.info(f"autotune: batch {bs} peaks at {peak / 2**30:.2f} GiB "
                 f"(budget {budget / 2**30:.2f} GiB)")
        if peak > budget:
            break
        best = bs
        bs *= 2
    if best is None:
        raise DeviceOutOfMemory(f"even batch_size={cfg.batch_size} exceeds the memory budget")
    return best
