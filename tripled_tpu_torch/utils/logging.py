"""Metric logging (`tripled_tpu/utils/logging.py`): an append-only JSONL
stream of scalar rows in the work dir, and an images/s meter. The JAX
package's optional TensorBoard mirror is not ported."""

from __future__ import annotations

import json
import os
import time
from typing import Mapping


class MetricLogger:
    def __init__(self, work_dir: str, filename: str = "metrics"):
        os.makedirs(work_dir, exist_ok=True)
        self._jsonl = open(os.path.join(work_dir, f"{filename}.jsonl"), "a")

    def log(self, step: int, metrics: Mapping[str, float], prefix: str = ""):
        """One row: {"step", "time", prefix + key: float value}; values
        that are not numbers are left out."""
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()


class StepTimer:
    """Wall-clock images/s after `warmup` skipped ticks."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.count = -warmup
        self.t0 = None
        self.imgs = 0

    def tick(self, batch_imgs: int):
        self.count += 1
        if self.count == 1:
            self.t0 = time.perf_counter()
            self.imgs = 0
        if self.count >= 1:
            self.imgs += batch_imgs

    @property
    def imgs_per_sec(self) -> float:
        if not self.t0 or self.count < 2:
            return 0.0
        return self.imgs / (time.perf_counter() - self.t0)
