"""The host's µs a call of K1 and of the latent block, on one checkout.

    python3 mopoe_mimic_tpu_torch/latent_host_us.py [--root DIR] [--rounds N] [--calls N]

Imports ``mopoe_mimic_tpu_torch`` from ``--root`` (default: the checkout
this file lies in), so that the same measurement runs on another commit
unpacked beside it with ``git archive``: two checkouts are compared in
turns (A B B A ...) on one card in one session. Needs a CUDA device.

At the flagship's latent shape (M = 3 posteriors [256, 64] float32 that
record gradients, as the encoders give them in training), each piece runs
``calls`` times back to back, timed with ``time.perf_counter`` up to a
synchronize after the last call, in ``rounds`` rounds that take the pieces
in turn. Prints one JSON line: each piece's median µs a call over the
rounds, and every round's value.

- ``k1 (stacked pair)``: ``poe_subsets_cuda`` on a stacked [M, B, D] pair;
- ``stack x2 + k1``: the two ``torch.stack`` calls and that call;
- ``k1 (separate)``: the call on the M posteriors in place, where the
  checkout's ``poe_subsets_cuda`` takes them;
- ``inference``: ``MMVae.inference`` of the flagship (joint_elbo) with its
  encoders replaced by the posteriors above: the latent block as the model
  runs it (K1, the subsets that enter the joint, the joint's selection);
- ``inference + backward``: that and the backward of the sum of every
  subset's and the joint's mean and log-variance.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def _timed(fn, calls: int) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def pieces(root: Path) -> dict:
    """The pieces to time, each a function of no arguments."""
    import numpy as np
    import torch

    from mopoe_mimic_tpu_torch.config import MopoeConfig
    from mopoe_mimic_tpu_torch.models.mmvae import MMVae
    from mopoe_mimic_tpu_torch.ops import fusion as F
    from mopoe_mimic_tpu_torch.ops.cuda_fusion import poe_subsets_cuda

    cfg = MopoeConfig.from_json(str(root / "configs" / "flagship.json"))
    names, device = cfg.modality_names, torch.device("cuda")
    rng = np.random.default_rng(0)
    mus, lvs = ([torch.from_numpy(rng.normal(size=(cfg.batch_size, cfg.class_dim))
                                  .astype(np.float32)).to(device).requires_grad_()
                 for _ in names] for _ in range(2))
    stacked = [torch.stack(x).detach().requires_grad_() for x in (mus, lvs)]
    mask = F.subset_mask_matrix(names)
    model = MMVae(cfg)  # the encoders stay unused on the host
    model.encode = lambda batch: {m: (mus[i], lvs[i]) for i, m in enumerate(names)}
    batch = dict.fromkeys(names)

    def inference_backward():
        out = model.inference(batch)
        loss = sum(mu.sum() + lv.sum() for mu, lv in out["subsets"].values())
        (loss + out["joint"][0].sum() + out["joint"][1].sum()).backward()

    out = {
        "k1 (stacked pair)": lambda: poe_subsets_cuda(*stacked, mask),
        "stack x2 + k1": lambda: poe_subsets_cuda(torch.stack(mus), torch.stack(lvs), mask),
        "k1 (separate)": lambda: poe_subsets_cuda(mus, lvs, mask),
        "inference": lambda: model.inference(batch),
        "inference + backward": inference_backward,
    }
    try:
        out["k1 (separate)"]()
    except (TypeError, AttributeError):  # a checkout whose kernel takes a stacked pair only
        del out["k1 (separate)"]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--rounds", type=int, default=7)
    parser.add_argument("--calls", type=int, default=500)
    args = parser.parse_args()
    root = args.root.resolve()
    sys.path[0] = str(root)  # this checkout's package, not the script's directory

    import torch

    if not torch.cuda.is_available():
        print("latent_host_us: needs a CUDA device", file=sys.stderr)
        return 1
    timed = pieces(root)
    for fn in timed.values():  # build, load and warm every path
        for _ in range(10):
            fn()
    rounds = {name: [] for name in timed}
    for _ in range(args.rounds):
        for name, fn in timed.items():
            rounds[name].append(_timed(fn, args.calls))
    print(json.dumps({"root": str(root), "calls": args.calls,
                      "median_us": {n: statistics.median(v) for n, v in rounds.items()},
                      "rounds_us": rounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
