"""The ``train`` driver: the program's training entry, ``run_epochs`` over
the graphed epoch, through the program's ``Experiment``.

Set-up, all counted in ``setup_s``:

1. the cell's studies made on the device from the seed
   (``traffic/structured.py``) and handed to an ``Experiment`` whose only
   change is ``set_datasets``; the store, the state and everything after
   them are the program's own;
2. the weights made from the seed (``reference/training.seeded_weights``)
   and loaded into the state that ``Experiment.init_state`` built;
3. ``run_epochs`` on that state, whose first epoch is set-up: it captures
   the step's graph and builds cuDNN's plans. Its epoch function, the one
   the window replays, is the program's ``make_train_epoch`` seen through
   ``first_steps``: the first epoch's index matrix goes to it as three
   calls, its first row, its next two rows and the rest, so that the check
   reads the state after the first step (its loss and Adam's first moment)
   and after the third (the losses and the parameters' change). Every
   later call goes to the program's function unchanged.

The window is the whole epochs after that first one, until ``--seconds``
have passed: the guard (``harness.WindowGuard``), passed as
``run_epochs``' ``preemption``, is read once an epoch after the callbacks.
With ``--trace 1`` one more epoch runs under the profiler. The
preemption's checkpoint is not written: the checkpoint manager is taken
from the experiment as the window closes (it would write the whole state
to disk after the window, in every run).

After the window the program's state is freed and the reference repeats
the first three steps on the same rows (``reference/training.py``).

``attempted`` and ``failed`` are counted over the window's first
``failure_horizon_epochs`` epochs (the workload file's), a fixed number of
training steps: the loop does not restart on NaN, so a run that diverges
trains NaN to the window's end, and a count over the whole window would
charge a faster program the extra epochs it runs after the same
divergence (``window_failures``). The whole window's ``window_epochs`` and
``nonfinite_epochs`` are readings of their own.
"""

from __future__ import annotations

import contextlib
import gc
import shutil
import time

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from harness import ROOT, Profile, WindowGuard, card, substream
from reference.mmvae import MMVae
from reference.training import (
    DROPOUT_SEED_OFFSET,
    compare,
    group_losses,
    model_sizes,
    reference_steps,
    seeded_weights,
)
from traffic.structured import StudySplit, studies

CALLS = (1, 2)  # the first epoch's first calls: one row, then two (the first three steps)
ADAM_BETA1 = 0.9
FAULTS = ("", "unchanged", "half_batch", "control")


def failure_horizon(cell: dict) -> int:
    """The workload file's ``failure_horizon_epochs``: the window epochs
    that ``attempted`` and ``failed`` count. No default."""
    horizon = cell.get("failure_horizon_epochs")
    if isinstance(horizon, bool) or not isinstance(horizon, int) or horizon < 1:
        raise ValueError(f"failure_horizon_epochs {horizon!r}: the workload file gives a "
                         "whole number of window epochs, 1 or more")
    return horizon


def nonfinite_epochs(train_losses) -> int:
    return sum(1 for loss in train_losses if not np.isfinite(loss))


def window_failures(train_losses, steps: int, horizon_epochs: int) -> tuple[int, int]:
    """(attempted, failed) steps of the window's first ``horizon_epochs``
    epochs, or of all of them where the window is shorter; an epoch whose
    train loss is not finite fails its ``steps``."""
    judged = train_losses[:horizon_epochs]
    return len(judged) * steps, steps * nonfinite_epochs(judged)


def program_config(cell: dict, config: dict, seed: int, root):
    from mopoe_mimic_tpu_torch.config import MopoeConfig

    keys = dict(config["config"])
    keys.update(seed=seed, dir_experiment=str(root), synthetic_length=cell["traffic"]["rows"])
    return MopoeConfig(**keys)


def make_experiment(cfg, splits, device):
    from mopoe_mimic_tpu_torch.experiment import Experiment

    class BenchExperiment(Experiment):
        def set_datasets(self) -> None:
            self.dataset_train, self.dataset_test = splits

    return BenchExperiment(cfg, name="run", device=device)


def batch_of(split: StudySplit, rows: np.ndarray, encoding: str, device) -> dict:
    """The reference's batch of ``rows``: images NCHW float32 in [0, 1]
    (uint8 × float32(1/255)), word ids, or char one-hots."""
    out = {}
    for m in ("PA", "Lateral"):
        img = torch.from_numpy(np.ascontiguousarray(split.arrays[m][rows])).to(device)
        out[m] = img.permute(0, 3, 1, 2).float() * (1.0 / 255.0)
    text = split.arrays["text"]
    if encoding == "word":
        out["text"] = torch.from_numpy(text[rows]).to(device)
    else:
        ids = torch.from_numpy(text.ids[rows]).to(device).long()
        out["text"] = torch.nn.functional.one_hot(ids, text.classes).float()
    return out


class HalfBatch:
    """A store whose gather leaves out the second half of each batch (the
    ``half_batch`` fault)."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        return getattr(self._store, name)

    def gather_fn(self, cols, idx):
        return self._store.gather_fn(cols, idx[: len(idx) // 2])


def _weighted_means(parts):
    """Epoch means of calls of ``n`` rows each, [(n, means)] → the means
    over all their rows."""
    total = sum(n for n, _ in parts)
    leaves = [tree_flatten(m) for _, m in parts]
    spec = leaves[0][1]
    merged = [sum(n * float(ls[0][i]) for (n, _), ls in zip(parts, leaves)) / total
              for i in range(len(leaves[0][0]))]
    return tree_unflatten(merged, spec)


def first_steps(make_train_epoch, weights_host: dict, record: dict, fault: str = ""):
    """The program's ``make_train_epoch`` as ``run_epochs`` gets it: the
    function it makes takes the first epoch as calls of ``CALLS`` rows and
    the rest, and writes into ``record`` the first three steps' rows, each
    call's loss, the first gradient as Adam got it (its first moment after
    one step over 1 - β1) and the parameters' change after the third step.
    ``half_batch`` plants that fault underneath: every batch gathered
    without its second half, the loss's mean over the rest."""

    def make(cfg, store, *args, **kwargs):
        if fault == "half_batch":
            cfg, store = cfg.replace(batch_size=cfg.batch_size // 2), HalfBatch(store)
        epoch_fn = make_train_epoch(cfg, store, *args, **kwargs)

        def train_epoch(state, idx_mat):
            if "rows" in record:
                return epoch_fn(state, idx_mat)
            idx = np.asarray(idx_mat)
            if len(idx) < sum(CALLS):
                raise ValueError(f"a first epoch of {len(idx)} steps: the check reads "
                                 f"{sum(CALLS)}")
            params = dict(state.model.named_parameters())
            parts, at = [], 0
            for n in CALLS:
                state, means = epoch_fn(state, idx[at:at + n])
                parts.append((n, means))
                at += n
                if "grad" not in record:
                    opt = state.optimizer.state
                    record["grad"] = {
                        k: (opt[p]["exp_avg"] / (1.0 - ADAM_BETA1)).cpu()
                        if "exp_avg" in opt.get(p, {}) else torch.zeros(p.shape)
                        for k, p in params.items()}
            record["change"] = {k: p.detach().cpu() - weights_host[k] for k, p in params.items()}
            record["losses"] = [float(m["total_loss"]) for _, m in parts]
            record["calls"] = list(CALLS)
            record["rows"] = idx[:at].copy()
            if at < len(idx):
                state, means = epoch_fn(state, idx[at:])
                parts.append((len(idx) - at, means))
            return state, _weighted_means(parts)

        return train_epoch

    return make


@contextlib.contextmanager
def observed_epochs(weights_host: dict, record: dict, fault: str):
    """``run_epochs`` takes its epoch function from ``first_steps`` while
    the context is open."""
    from mopoe_mimic_tpu_torch.train import scan

    program = scan.make_train_epoch
    scan.make_train_epoch = first_steps(program, weights_host, record, fault)
    try:
        yield
    finally:
        scan.make_train_epoch = program


def build(ctx: dict):
    """Set-up's steps 1-2 (module docstring): (the experiment, its state,
    the splits, the seeded weights on the host)."""
    seed, cell, config = ctx["seed"], ctx["cell"], ctx["config"]
    traffic = cell["traffic"]
    root = ROOT / "build" / "bench_runs" / ctx["workload"]
    shutil.rmtree(root, ignore_errors=True)
    cfg = program_config(cell, config, seed, root)
    dev = torch.device(ctx["device"])

    # 1. studies → the program's experiment
    size = {"img_size": cfg.img_size, "text_encoding": cfg.text_encoding,
            "vocab_size": cfg.vocab_size}
    splits = tuple(StudySplit(studies(n, size, traffic, substream(seed, s), dev),
                              cfg.text_encoding)
                   for s, n in ((1, traffic["rows"]), (2, traffic["test_rows"])))
    exp = make_experiment(cfg, splits, dev)
    state = exp.init_state()
    # the generators as Experiment.init_state documents them: the state's
    # (the noise) from the seed, the default one (dropout) from seed + 29.
    # On the card init_state leaves the default generator at the seed
    # itself (PERF.md, Open questions): seeded here, each run draws what the
    # documented streams give
    if dev.type == "cuda":
        torch.cuda.manual_seed(seed + DROPOUT_SEED_OFFSET)
    else:
        torch.manual_seed(seed + DROPOUT_SEED_OFFSET)
    state.generator.manual_seed(seed)

    # 2. the seeded weights
    weights = seeded_weights_for(ctx, dev)
    state.model.load_state_dict(weights)
    weights_host = {k: v.cpu() for k, v in weights.items()}
    del weights
    if ctx.get("fault") == "unchanged":
        state.optimizer.step = lambda *args, **kwargs: None
    return exp, state, splits, weights_host


def run(ctx: dict) -> dict:
    from mopoe_mimic_tpu_torch.train.loop import run_epochs

    fault = ctx.get("fault", "")
    if fault not in FAULTS:
        raise ValueError(f"fault {fault!r}: one of {FAULTS}")
    horizon = failure_horizon(ctx["cell"])
    dev = torch.device(ctx["device"])
    exp, state, splits, weights_host = build(ctx)
    cfg = exp.cfg
    bsz = cfg.batch_size

    # 3. run_epochs on the same state; its first epoch is set-up, the window after it
    steps = min(ctx["cell"]["traffic"]["rows"] // bsz, cfg.steps_per_training_epoch)
    profile = Profile() if ctx["trace"] else None

    def close():
        exp.checkpoints = None  # no preemption checkpoint after the window

    guard = WindowGuard(ctx["seconds"], profile, close)
    record: dict = {}
    with observed_epochs(weights_host, record, fault):
        result = run_epochs(exp, state=state, preemption=guard, device=dev)
    history = result["history"]
    if not guard.closed:
        raise RuntimeError(f"run_epochs ended after {len(history)} epochs before the window "
                           "closed: end_epoch or early stopping is within the window")
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stamps, end = guard.stamps, guard.window_end
    window = history[1:end + 1]
    readings = {
        "setup_s": stamps[0] - ctx["t_start"],
        "window_s": stamps[end] - stamps[0],
        "window_epochs": len(window),
        "steps_per_epoch": steps,
        "batch_size": bsz,
        "train_s": [h["seconds"]["train"] for h in window],
        "test_s": [h["seconds"]["test"] for h in window],
        "callbacks_s": [h["seconds"]["callbacks"] for h in window],
        "train_losses": [h["train_loss"] for h in window],
        "config": ctx["config"]["config"],
        "profile": profile.result if profile is not None else None,
        "memory_peak_bytes": memory_peak,
    }
    if dev.type == "cuda":
        readings["card"] = card()
        clock = readings["card"]["sm_max_clock_mhz"]
        readings["sm_clock_hz"] = float(clock) * 1e6 if clock.replace(".", "").isdigit() else None
    readings["nonfinite_epochs"] = nonfinite_epochs(readings["train_losses"])
    readings["attempted"], readings["failed"] = window_failures(readings["train_losses"],
                                                                steps, horizon)

    # the program's state freed; then the reference's first steps
    del result, state, exp
    free(dev)
    t_ref = time.perf_counter()
    ref = reference_readings(ctx, splits[0], record["rows"])
    prog = {k: record[k] for k in ("losses", "calls", "grad", "change")}
    if fault == "control":  # the reference one precision down in the program's place
        readings["program_check"] = compare(ref, prog)
        control = reference_readings(ctx, splits[0], record["rows"], "fp8")
        prog = dict(control, losses=group_losses(control["losses"], record["calls"]),
                    calls=record["calls"])
    readings["check"] = compare(ref, prog)
    readings["check_s"] = time.perf_counter() - t_ref
    return readings


def free(dev) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def reference_inputs(ctx, split, rows, dev):
    """The reference's batches and noise for the first steps: the same
    studies, and the draws a generator seeded with the run's seed gives."""
    cfg = ctx["config"]["config"]
    batches = [batch_of(split, r, cfg["text_encoding"], dev) for r in rows]
    gen = torch.Generator(dev).manual_seed(ctx["seed"])
    eps = [torch.randn((len(r), cfg["class_dim"]), generator=gen, device=dev) for r in rows]
    return batches, eps


@contextlib.contextmanager
def tf32_off():
    """Float32 products and convolutions in float32, for the reference
    alone; the program runs under PyTorch's defaults, as its entry does."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def reference_readings(ctx, split, rows, precision: str = "float32") -> dict:
    """The reference's first steps from the run's seed on ``rows``, in
    ``precision``."""
    dev = torch.device(ctx["device"])
    cfg = ctx["config"]["config"]
    with tf32_off():
        batches, eps = reference_inputs(ctx, split, rows, dev)
        weights = seeded_weights_for(ctx, dev)
        mask_dtype = torch.bfloat16 if cfg.get("compute_dtype", "bfloat16") == "bfloat16" \
            else torch.float32
        ref = reference_steps(cfg, weights, batches, eps, ctx["seed"], precision, mask_dtype)
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v)
            for k, v in ref.items()}


def seeded_weights_for(ctx, dev):
    with torch.device("meta"):
        shape_model = MMVae(model_sizes(ctx["config"]["config"]))
    return seeded_weights(shape_model, substream(ctx["seed"], 3), dev)
