"""The cumulative results CSV: one row a run, every config field and the
flattened test metrics, updated after every test epoch
(mopoe_mimic_tpu/utils/experiment_df.py; reference
mimic/utils/experiment.py:227-260 ``experiments_dataframe.csv``).

Written with the standard library's ``csv`` (no pandas), with the JAX
package's columns in its order: ``str_experiment``, the config fields,
then each metric as it first arrives. Every cell is kept as the text it was
written as; None and NaN are empty cells, as pandas writes them.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Any, Dict, List, Mapping, Tuple

from mopoe_mimic_tpu_torch.utils import profiling
from mopoe_mimic_tpu_torch.utils.meters import flatten_metrics

KEY = "str_experiment"


def _cell(v: Any) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return str(v)


class ExperimentDataframe:
    def __init__(self, path: str, cfg, run_name: str):
        self.path = Path(path)
        self.run_name = run_name
        row: Dict[str, Any] = {KEY: run_name}
        row.update({k: str(v) if isinstance(v, (list, tuple, dict)) else v
                    for k, v in cfg.to_dict().items()})
        header, rows = self._load()
        header += [k for k in row if k not in header]
        if any(r[KEY] == run_name for r in rows):
            # reattach (--load_run, a resume after preemption): the existing
            # row, its config fields refreshed and its metrics kept; later
            # duplicates of it dropped
            kept, seen = [], False
            for r in rows:
                if r[KEY] == run_name:
                    if seen:
                        continue
                    seen = True
                    r.update({k: _cell(v) for k, v in row.items()})
                kept.append(r)
            rows = kept
        else:
            rows.append({k: _cell(v) for k, v in row.items()})
        self._write(header, rows)

    def _load(self) -> Tuple[List[str], List[Dict[str, str]]]:
        if not self.path.exists():
            return [], []
        with open(self.path, newline="") as f:
            reader = csv.DictReader(f, restval="")
            rows = list(reader)
            return list(reader.fieldnames or []), rows

    def _write(self, header: List[str], rows: List[Dict[str, str]]) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=header, restval="")
            writer.writeheader()
            writer.writerows(rows)
        tmp.replace(self.path)

    def update(self, values: Mapping[str, Any]) -> None:
        """Flatten metric values (names joined by ``_``) into this run's row
        (the span ``loop.csv``: the file is read and written whole)."""
        with profiling.span("loop.csv"):
            flat = flatten_metrics(dict(values), sep="_")
            header, rows = self._load()
            header += [k for k in flat if k not in header]
            for r in rows:
                if r[KEY] == self.run_name:
                    r.update({k: _cell(v) for k, v in flat.items()})
            self._write(header, rows)

    def delete_row(self) -> None:
        """Drop this run's row (restart semantics, main_mimic.py:79-98)."""
        header, rows = self._load()
        self._write(header, [r for r in rows if r[KEY] != self.run_name])
