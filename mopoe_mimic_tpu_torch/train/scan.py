"""Whole-epoch training and evaluation with the batches gathered on the
card from a ``DeviceStore``, and one host read an epoch.

Port of ``mopoe_mimic_tpu/train/scan.py``, whose epoch is one ``lax.scan``
over the step body. Here, on the card, one step is captured in a CUDA
graph: the gather from a static index buffer (``store.gather_fn``), the
step body (``train/step.make_train_step_body``) and an add of every metric
into static sums on the card. The graph is replayed once per row of the
epoch's index matrix; the matrix is uploaded once an epoch and each row is
copied card to card into the index buffer, so the host launches a copy and
a graph a step and waits for nothing until the epoch's means are read,
once, at its end. On the CPU the same body runs as a plain loop, with the
same sums and the same single read.

The capture is made at the first call and again when the state's tensors
move (another state, a new batch size, gradients or optimizer state made
anew): the step is first run on a side stream, which builds what a first
call builds (the optimizer's state, the gradients, cuDNN's plans, the
kernels' cached layouts and launch attributes), then the state is put back
as it was and one step is captured, so the warm-up does not count as a
step. ``state.generator`` is registered with the graph, so each replay
draws the noise the eager step would draw next. A capture that fails
raises: there is no eager fallback on the card (``cfg.scan_epochs=False``
is the per-step path, as in the JAX loop).

Numerics match the per-step path: the same body, the same epoch order
(``DeviceStore.epoch_order``), and the eval pass advances its generator
batch by batch as the per-step loop's would (the JAX rng split chain).

Spans (``utils/profiling``): ``scan.capture`` (the warm-up and the
capture, ``kind`` train or eval), and in each call ``scan.upload`` (the
index matrix to the device), on the card ``scan.graph_key`` (the state's
tensors' addresses, which decide whether to capture again),
``scan.replays`` (the replays' enqueue, on the CPU the steps; ``stamps``
holds a ``perf_counter_ns`` taken just before each replay) and
``scan.read_means`` (the one read). Counters: ``scan.captures.<kind>``,
``scan.replays.<kind>`` and ``scan.reads``. A replay adds the launches its
capture made to the kernels' ``LAUNCHES``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from mopoe_mimic_tpu_torch.ops import _build
from mopoe_mimic_tpu_torch.train.state import TrainState
from mopoe_mimic_tpu_torch.train.step import (
    Eps,
    make_eval_step_body,
    make_train_step_body,
    static_grads,
)
from mopoe_mimic_tpu_torch.utils import profiling

WARMUP_STEPS = 2  # eager steps on a side stream before a capture


def _metric_vector(metrics) -> Tuple[torch.Tensor, Any]:
    """A step's metric tree → (its leaves as one float64 vector on the
    device, the tree's structure)."""
    leaves, spec = tree_flatten(metrics)
    return torch.stack([x.to(torch.float64) for x in leaves]), spec


def _mean_over_steps(sums: torch.Tensor, n_steps: int, spec) -> Any:
    """Epoch sums of every metric → the epoch means as a tree of floats
    (flags such as ``nan_in_latents`` become rates): the epoch's one read
    of the device (the span ``scan.read_means``, counted in ``scan.reads``)."""
    with profiling.span("scan.read_means"):
        means = (sums / n_steps).tolist()
    profiling.count("scan.reads")
    return tree_unflatten(means, spec)


def _index_rows(idx_mat, device: torch.device) -> torch.Tensor:
    """The [n_steps, B] index matrix on ``device``, int32, in one copy
    (from pinned memory to the card, which does not wait for the host)."""
    with profiling.span("scan.upload"):
        idx = torch.as_tensor(np.asarray(idx_mat, np.int32))
        if idx.ndim != 2 or idx.shape[0] == 0:
            raise ValueError(f"index matrix of shape {tuple(idx.shape)}: need [n_steps > 0, B]")
        if device.type == "cuda":
            return idx.pin_memory().to(device, non_blocking=True)
        return idx.to(device)


def _replays(kind: str, rows: torch.Tensor) -> profiling.Span:
    """The span ``scan.replays`` of a call over ``rows``; its ``stamps``
    take a ``perf_counter_ns`` just before each replay (or step)."""
    return profiling.span("scan.replays", kind=kind, steps=len(rows), stamps=[])


def _addresses(tensors) -> Tuple[int, ...]:
    return tuple(0 if t is None else t.data_ptr() for t in tensors)


def _train_tensors(state: TrainState) -> List[Optional[torch.Tensor]]:
    """Every tensor a captured train step reads or writes that outlives
    the step: parameters and buffers, gradients, the optimizer's state and
    learning rates, the device step count."""
    opt = state.optimizer
    tensors = [*state.model.state_dict().values(), state.step_t]
    for group in opt.param_groups:
        tensors += [group["lr"], group["base_lr"]]
        for p in group["params"]:
            tensors += [p.grad, *opt.state[p].values()]
    return tensors


class _CapturedStep:
    """One step captured in a CUDA graph: ``step(idx)`` on a static index
    buffer, its metric vector added into static sums. ``kind`` (train or
    eval) names it in the spans and counters. The warm-up's launches are
    counted; the capture's are not, and ``launches`` holds them, which
    every replay counts."""

    def __init__(self, step: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]],
                 batch_size: int, device: torch.device, generator: torch.Generator,
                 restore: Callable[[], None], kind: str):
        self.kind = kind
        with profiling.span("scan.capture", kind=kind):
            self.idx = torch.zeros(batch_size, dtype=torch.int32, device=device)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    vec, self.spec = step(self.idx)
            torch.cuda.current_stream(device).wait_stream(side)
            restore()
            self.sums = torch.zeros_like(vec)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.register_generator_state(generator)

            def capture():
                with torch.cuda.graph(self.graph):
                    vec, _ = step(self.idx)
                    self.sums += vec

            self.launches = _build.uncounted(capture)
        profiling.count(f"scan.captures.{kind}")

    def run(self, rows: torch.Tensor) -> torch.Tensor:
        """Replay once per row of ``rows`` (on the card); the sums."""
        self.sums.zero_()
        with _replays(self.kind, rows) as sp:
            stamps = sp.attrs["stamps"]
            for row in rows:
                self.idx.copy_(row)
                stamps.append(time.perf_counter_ns())
                self.graph.replay()
                _build.add_launches(self.launches)
        profiling.count(f"scan.replays.{self.kind}", len(rows))
        return self.sums


def _train_snapshot(state: TrainState) -> Callable[[], None]:
    """A copy of what a train step changes; the function that puts it back
    (in place, so every tensor keeps its storage). Optimizer state that a
    step creates after the copy is zeroed: Adam's fresh state. On the card
    the default generator (dropout's) is put back too."""
    pairs = [(t, t.clone()) for t in _train_tensors(state) if t is not None]
    kept = {t.data_ptr() for t, _ in pairs}
    generator = state.generator.get_state()
    device = state.step_t.device
    default = torch.cuda.get_rng_state(device) if device.type == "cuda" else None

    def restore():
        with torch.no_grad():
            for t, copy in pairs:
                t.copy_(copy)
            for t in _train_tensors(state):
                if t is not None and t.data_ptr() not in kept:
                    t.zero_()
        state.generator.set_state(generator)
        if default is not None:
            torch.cuda.set_rng_state(default, device)

    return restore


def make_train_epoch(cfg, store, eps: Eps = None
                     ) -> Callable[[TrainState, np.ndarray], Tuple[TrainState, Dict]]:
    """``train_epoch(state, idx_mat) -> (state, epoch-mean metrics)``: one
    train step per row of ``idx_mat`` [n_steps, B] (store indices), the
    state updated in place, the means as a tree of floats. On the card the
    step is a CUDA graph replay (module docstring)."""
    body = make_train_step_body(cfg, eps)
    captured: Dict[str, Any] = {}

    def step(state, idx):
        return _metric_vector(body(state, store.gather_fn(store.cols, idx)))

    def graph_for(state, batch_size) -> _CapturedStep:
        # the state is kept beside its key, so that its id stays its own
        with profiling.span("scan.graph_key"):
            key = (id(state), batch_size, _addresses(_train_tensors(state)))
        if captured.get("key") != key:
            captured.clear()
            static_grads([p for g in state.optimizer.param_groups for p in g["params"]])
            restore = _train_snapshot(state)
            graph = _CapturedStep(lambda idx: step(state, idx), batch_size, store.device,
                                  state.generator, restore, "train")
            key = (id(state), batch_size, _addresses(_train_tensors(state)))
            captured.update(graph=graph, key=key, state=state)
        return captured["graph"]

    def train_epoch(state: TrainState, idx_mat) -> Tuple[TrainState, Dict]:
        rows = _index_rows(idx_mat, store.device)
        if store.device.type == "cuda":
            graph = graph_for(state, rows.shape[1])
            sums, spec = graph.run(rows), graph.spec
        else:
            sums = 0.0
            with _replays("train", rows) as sp:
                for row in rows:
                    sp.attrs["stamps"].append(time.perf_counter_ns())
                    vec, spec = step(state, row)
                    sums = sums + vec
        state.step += rows.shape[0]
        return state, _mean_over_steps(sums, rows.shape[0], spec)

    return train_epoch


def make_eval_epoch(cfg, store, eps: Eps = None
                    ) -> Callable[[TrainState, torch.Generator, np.ndarray],
                                  Tuple[torch.Generator, Dict]]:
    """``eval_epoch(state, generator, idx_mat) -> (generator, epoch-mean
    metrics)``: the eval step (eval mode, no gradients) per row of
    ``idx_mat``, the noise from ``generator``, which advances batch by batch
    as the per-step loop's would. On the card the step is its own CUDA
    graph, drawing from a generator of the graph's own that takes
    ``generator``'s state before the replays and hands it back after."""
    body = make_eval_step_body(cfg, eps)
    captured: Dict[str, Any] = {}

    def step(state, idx, generator):
        return _metric_vector(body(state, store.gather_fn(store.cols, idx), generator))

    def graph_for(state, batch_size) -> _CapturedStep:
        with profiling.span("scan.graph_key"):
            key = (id(state), batch_size, _addresses(state.model.state_dict().values()))
        if captured.get("key") != key:
            captured.clear()
            own = torch.Generator(store.device)
            graph = _CapturedStep(lambda idx: step(state, idx, own), batch_size, store.device,
                                  own, lambda: None, "eval")
            captured.update(graph=graph, generator=own, key=key, state=state)
        return captured["graph"]

    def eval_epoch(state: TrainState, generator: torch.Generator, idx_mat
                   ) -> Tuple[torch.Generator, Dict]:
        rows = _index_rows(idx_mat, store.device)
        if store.device.type == "cuda":
            graph = graph_for(state, rows.shape[1])
            own = captured["generator"]
            own.set_state(generator.get_state())
            sums, spec = graph.run(rows), graph.spec
            generator.set_state(own.get_state())
        else:
            sums = 0.0
            with _replays("eval", rows) as sp:
                for row in rows:
                    sp.attrs["stamps"].append(time.perf_counter_ns())
                    vec, spec = step(state, row, generator)
                    sums = sums + vec
        return generator, _mean_over_steps(sums, rows.shape[0], spec)

    return eval_epoch


def epoch_index_matrix(store, epoch: int, batch_size: int, seed: int = 0,
                       weighted: bool = False, steps_cap: Optional[int] = None) -> np.ndarray:
    """[n_steps, B] int32 epoch order: the same draw ``iter_epoch`` makes
    (drop_last, the same rng stream), optionally capped like the loop's
    steps_per_training_epoch."""
    order = store.epoch_order(epoch, seed=seed, weighted=weighted)
    nb = len(order) // batch_size
    if nb == 0 and len(order) > 0:
        # a split smaller than one batch: one wraparound-padded batch
        # (repeated rows) instead of a zero-step epoch
        return np.resize(order, batch_size).reshape(1, batch_size).astype(np.int32)
    if steps_cap:
        nb = min(nb, steps_cap)
    return order[: nb * batch_size].reshape(nb, batch_size).astype(np.int32)
