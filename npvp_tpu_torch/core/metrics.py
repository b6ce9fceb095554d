"""Metric aggregation and logging (port of ``npvp_tpu/core/metrics.py``):
running means that read device scalars only when asked, and a JSON-lines
scalar log (the card's machine has no TensorBoard)."""

from __future__ import annotations

import json
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict


class AverageMeters:
    """Running means keyed by name. Values may be 0-d tensors on the card;
    they are read back only in :meth:`averages`, so the training loop does
    not wait for the device at every step."""

    def __init__(self):
        self._values: Dict[str, list] = defaultdict(list)

    def update(self, metrics: Dict[str, object]) -> None:
        for k, v in metrics.items():
            self._values[k].append(v.detach() if hasattr(v, "detach") else v)

    def averages(self) -> Dict[str, float]:
        return {k: sum(float(x) for x in v) / len(v)
                for k, v in self._values.items()}


class MetricsLogger:
    """Appends one JSON object per call to ``<log_dir>/metrics.jsonl``."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time(),
                  **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
