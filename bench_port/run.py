"""Run one cell of the port's benchmark once.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything is found by name:

* ``BENCHMARK.json`` (the checkout's root) names the cell's configuration
  and its metrics;
* ``bench_port/workloads/<cell>.json``: the driver kind, the traffic
  parameters and the limits of the check;
* ``bench_port/configs/<config>.json``: the configuration as it is run;
* ``bench_port/drivers/<kind>.py``: the driver, whose ``run(ctx)`` drives
  the program and returns its readings, the check's numbers among them;
* ``bench_port/metrics/<metric>.py``: each metric's reader, whose
  ``read(readings)`` gives its value, or None where there is nothing to
  read (the metric is then left out of the line).

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones, ``busy_s``, ``window_s`` and the
breakdown. The last line of standard output is that JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error and the line's last key. Without a CUDA device, or with
fewer than the cell asks for, it exits 3 and prints no result; it exits 4
if JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "mopoe_mimic_tpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(workload: str):
    """(BENCHMARK.json, its workload entry, the workload file, the
    configuration file)."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cell = json.loads((BENCH_DIR / "workloads" / f"{workload}.json").read_text())
    config = json.loads((ROOT / config_entry["file"]).read_text())
    return bench, entry, cell, config


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The metrics the line carries: the cell's end-to-end ones, or its
    per-layer ones (those that list the cell, or list none and move an
    end-to-end metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def applies(m):
        return workload in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if applies(m)]


def imported_forbidden():
    return sorted(k for k in sys.modules if k in FORBIDDEN or k.startswith(
        tuple(f"{f}." for f in FORBIDDEN)))


def execute(bench: dict, entry: dict, cell: dict, config: dict, workload: str, seed: int,
            seconds: float, trace: bool, device: str = "cuda", fault: str = ""):
    """Drive the cell once; (the result line, the numbers compared with
    their limits, the driver's readings). ``fault`` plants one of the
    faults the check must catch (its own tests only)."""
    import torch

    for p in (str(ROOT), str(BENCH_DIR)):
        if p not in sys.path:
            sys.path.insert(0, p)
    driver = load_module(BENCH_DIR / "drivers" / f"{cell['driver']}.py",
                         f"bench_driver_{cell['driver']}")
    ctx = {"workload": workload, "seed": seed % 2 ** 63, "seconds": seconds, "trace": trace,
           "cell": cell, "config": config, "device": device, "t_start": T_START,
           "chips": entry["chips"], "fault": fault}
    readings = driver.run(ctx)

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                            f"bench_metric_{m['name']}").read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell.get("limits", {})
    compared = {k: [readings["check"][k], limits.get(k)] for k in cell["compared"]}
    correct = all(lim is not None and math.isfinite(v) and v <= lim
                  for v, lim in compared.values())
    on_cuda = device == "cuda"
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": readings["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": readings["attempted"],
            "failed": readings["failed"], "metrics": metrics, "device": dev}
    prof = readings.get("profile")
    if trace and prof is not None:
        from harness import breakdown

        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["wall_s"]
        line["breakdown"] = breakdown(prof)
    line["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return line, compared, readings


def side_numbers(readings: dict, compared: dict) -> dict:
    """What standard error carries before the compared numbers: the card,
    the whole window's epochs and those whose train loss is not finite
    (``failed`` counts only the first ``failure_horizon_epochs``), and the
    check's numbers that are not compared."""
    return {"card": readings.get("card"), "window_epochs": readings["window_epochs"],
            "nonfinite_epochs": readings["nonfinite_epochs"],
            **{k: v for k, v in readings["check"].items() if k not in compared}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, entry, cell, config = cell_files(args.workload)
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload}: needs {entry['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    line, compared, readings = execute(bench, entry, cell, config, args.workload, args.seed,
                                       args.seconds, bool(args.trace))
    bad = imported_forbidden()
    if bad:
        print(f"imported {bad}: the benchmark runs the port alone", file=sys.stderr)
        return 4
    print(json.dumps(side_numbers(readings, compared)), file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
