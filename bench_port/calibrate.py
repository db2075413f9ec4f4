"""The readings a training cell's check limits are set from, on the card at
the cell's own size, in one process: short runs of the cell through
``run.execute``, each judged by the cell's committed limits.

* ``--seeds``: the program (the lower readings);
* ``--control-seeds``: the control, the reference computed with float8
  operands in the program's place (an upper reading); the same run also
  reads the program;
* ``--fault-seeds``: the program with half of each batch left out and the
  mean taken over the rest (an upper reading);
* ``--unchanged-seeds``: the program with a step that leaves the state
  unchanged (an upper reading of the losses; it reads 1 on ``change`` by
  that number's definition).

One JSON line a reading, with ``correct`` as
the committed limits judge it, then the maxima and minima by kind.

    python3 bench_port/calibrate.py --workload train.word128 \\
        --seeds 1,2,3 --control-seeds 1 --fault-seeds 2
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR.parent), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402

NUMBERS = ("loss", "loss_2_3", "grad", "change", "grad_worst", "change_worst")
KINDS = (("program", "seeds", ""), ("control", "control_seeds", "control"),
         ("half_batch", "fault_seeds", "half_batch"),
         ("unchanged", "unchanged_seeds", "unchanged"))


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--unchanged-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0, help="each run's window")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench, entry, cell, config = run.cell_files(args.workload)

    out = {kind: [] for kind, _, _ in KINDS}

    def note(kind, seed, check, correct, seconds):
        out[kind].append({k: check[k] for k in NUMBERS})
        print(json.dumps({"kind": kind, "seed": seed, "correct": correct, **check,
                          "seconds": seconds}), flush=True)

    for kind, attr, fault in KINDS:
        if kind == "program":  # control runs read the program too
            todo = [s for s in getattr(args, attr) if s not in args.control_seeds]
        else:
            todo = getattr(args, attr)
        for seed in todo:
            t0 = time.perf_counter()
            line, _, readings = run.execute(bench, entry, cell, config, args.workload, seed,
                                            args.seconds, False, args.device, fault=fault)
            seconds = time.perf_counter() - t0
            if fault == "control":
                note("program", seed, readings["program_check"], None, seconds)
            note(kind, seed, readings["check"], line["correct"], seconds)
            del line, readings
    summary = {}
    for kind, rows in out.items():
        if rows:
            agg = max if kind == "program" else min
            summary[kind] = {k: agg(r[k] for r in rows) for k in NUMBERS}
    print(json.dumps({"summary": summary, "upper_is": "min over control and fault seeds",
                      "lower_is": "max over program seeds"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
