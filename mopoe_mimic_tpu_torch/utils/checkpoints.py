"""Checkpoints of the whole train state with true resume and best-k
retention (mopoe_mimic_tpu/utils/checkpoints.py).

A checkpoint is ``<directory>/<epoch>/``: ``state.pt`` (``torch.save`` of
the model's ``state_dict`` with its BN buffers, the optimizer's state,
``step``, ``step_t``, the state's generator, the default generator of the
parameters' device, which dropout draws from, the epoch and the metrics)
and ``metrics.json``. A save writes ``<epoch>.tmp/`` and renames it, so an
epoch on disk is complete; a ``.tmp`` left by a crash is removed when the
manager opens. The reference saves per-network weights every 50 epochs and
never the optimizer (SURVEY.md §5).

Retention as the JAX manager's orbax policy: the ``max_to_keep`` lowest
``test_loss`` values (a later epoch first among equal ones) plus always the
latest epoch, and every save without metrics; ``best_epoch`` is the lowest
loss kept. A save of an epoch not above the latest is skipped unless
forced (orbax's ``should_save``); a forced save of an epoch on disk writes
it again.

Staged best (``stage``/``flush_staged``): an improvement between
checkpoint boundaries is held as a copy on the device and written only at
the next boundary, early stop, read or ``close``, as in the JAX package; a
newer stage replaces an unflushed one, and a save of a later epoch writes
the staged one first. Writes are synchronous: the JAX package's background
writer and its device copy against buffer donation answer the TPU's
host link, which the card does not have. ``save_seconds`` adds up the
wall time of the writes.

``restore`` puts the checkpoint back into the given state in place: the
parameters, buffers, optimizer state, learning rates and step count keep
their tensors (a CUDA graph captured on them stays valid), and optimizer
state the state did not have yet is made on the parameters' device (a
graph of ``train/scan.py`` is then captured again, its key having changed).
Each group's ``lr`` and ``base_lr`` stay tensors on the parameters'
device, as the capturable Adam needs (``train/state.py``).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

STATE_FILE, METRICS_FILE = "state.pt", "metrics.json"


def _default_rng_state(device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_default_rng_state(device: torch.device, value: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(value, device)
    else:
        torch.set_rng_state(value)


def state_payload(state, copy: bool = False) -> Dict[str, Any]:
    """What a checkpoint holds of a ``TrainState``; ``copy`` clones every
    tensor where it lies (a snapshot that later steps do not change)."""
    device = state.step_t.device
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": int(state.step), "step_t": state.step_t,
               "generator": state.generator.get_state(),
               "default_generator": _default_rng_state(device)}
    if copy:
        payload = tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
                           payload)
    return payload


def load_state_payload(state, payload: Dict[str, Any]) -> None:
    """Put a checkpoint's payload back into ``state`` in place (module
    docstring)."""
    device = state.step_t.device
    with torch.no_grad():
        state.model.load_state_dict(payload["model"])
        opt, saved = state.optimizer, payload["optimizer"]
        params = [p for g in opt.param_groups for p in g["params"]]
        ids = [i for g in saved["param_groups"] for i in g["params"]]
        if len(params) != len(ids) or len(opt.param_groups) != len(saved["param_groups"]):
            raise ValueError(f"checkpoint of {len(ids)} parameters for an optimizer of "
                             f"{len(params)}")
        for p, i in zip(params, ids):
            src = saved["state"].get(i)
            if not src:
                opt.state.pop(p, None)
                continue
            dst = opt.state.get(p)
            if dst and dst.keys() == src.keys() and all(
                    dst[k].shape == src[k].shape and dst[k].dtype == src[k].dtype for k in src):
                for k, v in src.items():
                    dst[k].copy_(v)
            else:
                opt.state[p] = {k: v.to(p.device) for k, v in src.items()}
        for group, saved_group in zip(opt.param_groups, saved["param_groups"]):
            for k, v in saved_group.items():
                if k == "params":
                    continue
                if isinstance(group.get(k), torch.Tensor):
                    group[k].copy_(v)
                else:
                    group[k] = v.to(device) if isinstance(v, torch.Tensor) else v
        state.step_t.copy_(payload["step_t"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    _set_default_rng_state(device, payload["default_generator"])


def _test_loss(metrics) -> float:
    return float(metrics["test_loss"])


def kept_epochs(infos: List[Tuple[int, Optional[Dict]]], max_to_keep: int) -> List[int]:
    """orbax's ``AnyPreservationPolicy([BestN(n=max_to_keep, reverse=True),
    LatestN(1)])`` on ``infos`` [(epoch, metrics or None)] in epoch order:
    the epochs it keeps."""
    keep = set()
    if len(infos) <= max_to_keep:
        keep.update(e for e, _ in infos)
    else:
        with_metrics = sorted((i for i in infos if i[1] is not None),
                              key=lambda i: _test_loss(i[1]), reverse=True)
        keep.update(e for e, _ in with_metrics[-max_to_keep:] if max_to_keep > 0)
        keep.update(e for e, m in infos if m is None)
    if infos:
        keep.add(infos[-1][0])
    return sorted(keep)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        for tmp in self.directory.glob("*.tmp"):  # a save that did not finish
            shutil.rmtree(tmp, ignore_errors=True)
        self.max_to_keep = max_to_keep
        self.save_seconds = 0.0
        self._staged: Optional[Tuple[int, Dict[str, Any], Optional[Dict]]] = None

    # -- disk ---------------------------------------------------------------

    def _on_disk(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def _metrics(self, epoch: int) -> Optional[Dict]:
        with open(self.directory / str(epoch) / METRICS_FILE) as f:
            return json.load(f)

    def _write(self, epoch: int, payload: Dict[str, Any], metrics: Optional[Dict],
               force: bool) -> bool:
        on_disk = self._on_disk()
        if not force and on_disk and on_disk[-1] >= epoch:
            return False
        t0 = time.perf_counter()
        tmp, final = self.directory / f"{epoch}.tmp", self.directory / str(epoch)
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        metrics = None if metrics is None else {k: float(v) for k, v in metrics.items()}
        host = tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t, payload)
        torch.save({**host, "epoch": int(epoch), "metrics": metrics}, tmp / STATE_FILE)
        with open(tmp / METRICS_FILE, "w") as f:
            json.dump(metrics, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        infos = [(e, self._metrics(e)) for e in self._on_disk()]
        keep = set(kept_epochs(infos, self.max_to_keep))
        for e, _ in infos:
            if e not in keep:
                shutil.rmtree(self.directory / str(e), ignore_errors=True)
        self.save_seconds += time.perf_counter() - t0
        return True

    # -- public API ---------------------------------------------------------

    def save(self, epoch: int, state, force: bool = False,
             metrics: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``state`` as ``epoch`` (after a staged earlier epoch, which
        a save of the same epoch replaces); False where skipped."""
        if self._staged is not None:
            s_epoch, s_payload, s_metrics = self._staged
            self._staged = None
            if s_epoch < epoch:
                self._write(s_epoch, s_payload, s_metrics, force=False)
        return self._write(epoch, state_payload(state), metrics, force)

    def stage(self, epoch: int, state, metrics: Optional[Dict[str, float]] = None) -> None:
        """Hold a copy of ``state`` on its device as the pending best, not
        written until ``flush_staged``."""
        self._staged = (epoch, state_payload(state, copy=True), metrics)

    def flush_staged(self) -> None:
        if self._staged is None:
            return
        epoch, payload, metrics = self._staged
        self._staged = None
        self._write(epoch, payload, metrics, force=False)

    def wait_until_finished(self) -> None:
        """Writes are synchronous: only the staged best is left to write."""
        self.flush_staged()

    def restore(self, state, epoch: Optional[int] = None) -> Tuple[int, Any]:
        """(epoch, ``state``) with the checkpoint of ``epoch`` (default: the
        latest) put back into ``state`` in place."""
        epoch, payload = self.read(epoch)
        load_state_payload(state, payload)
        return epoch, state

    def read(self, epoch: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """(epoch, the checkpoint's payload on the host) of ``epoch``
        (default: the latest); the model's weights are its ``"model"``."""
        self.wait_until_finished()
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return epoch, torch.load(self.directory / str(epoch) / STATE_FILE, map_location="cpu",
                                 weights_only=True)

    def latest_epoch(self) -> Optional[int]:
        self.wait_until_finished()
        on_disk = self._on_disk()
        return on_disk[-1] if on_disk else None

    def best_epoch(self) -> Optional[int]:
        """The epoch of the lowest test loss kept (None without metrics)."""
        self.wait_until_finished()
        scored = [(e, m) for e in self._on_disk() if (m := self._metrics(e)) is not None]
        if not scored:
            return None
        return sorted(scored, key=lambda i: _test_loss(i[1]), reverse=True)[-1][0]

    def all_epochs(self) -> List[int]:
        self.wait_until_finished()
        return self._on_disk()

    def close(self) -> None:
        self.flush_staged()

