"""Metric logging behind a thin interface: append-only JSONL and CSV files.

Counterpart of ``deepbedmap_tpu/utils/logging.py``, copied (stdlib only). The
reference streams parameters and metrics to Comet.ML; any tracker can
implement this surface, and the built-in sink writes JSONL + CSV locally.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict


class MetricLogger:
    """Append-only JSONL (+ optional CSV) experiment logger.

    Usage mirrors the reference's per-epoch `experiment.log_metrics(...,
    step=i)` (srgan_train.py:1635): ``logger.log_metrics(record, step=i)``.
    """

    def __init__(self, directory: str, name: str = "experiment", csv_also: bool = True):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.jsonl")
        self.csv_path = os.path.join(directory, f"{name}.csv") if csv_also else None
        self._csv_fields = None

    def log_params(self, params: Dict) -> None:
        self._write({"type": "params", "ts": time.time(), **params})

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        record = {"type": "metrics", "step": step, "ts": time.time(), **metrics}
        self._write(record)
        if self.csv_path is not None:
            fields = ["step"] + sorted(k for k in metrics)
            new_file = self._csv_fields is None
            if new_file:
                self._csv_fields = fields
            with open(self.csv_path, "a", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=self._csv_fields, extrasaction="ignore")
                if new_file:
                    writer.writeheader()
                writer.writerow({"step": step, **metrics})

    def _write(self, record: Dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
