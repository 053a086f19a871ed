"""Metric logging and profiling (`tripled_tpu/utils/logging.py`).

- `MetricLogger`: an append-only JSONL stream of scalar rows in the work
  dir, mirrored to TensorBoard under `<work_dir>/tb` when
  `TRIPLED_TENSORBOARD=1` (`torch.utils.tensorboard`). Where TensorBoard
  does not import, the JAX logger goes on silently; this one logs a
  warning and goes on with the JSONL stream alone.
- `profile_trace`: `torch.profiler` over a block, written as a Chrome trace.
- `StepTimer`: an images/s meter.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Mapping

import torch


class MetricLogger:
    def __init__(self, work_dir: str, filename: str = "metrics"):
        os.makedirs(work_dir, exist_ok=True)
        self._jsonl = open(os.path.join(work_dir, f"{filename}.jsonl"), "a")
        self._tb = None
        if os.environ.get("TRIPLED_TENSORBOARD", "0") == "1":
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                logging.getLogger("tripled_tpu_torch").warning(
                    "TRIPLED_TENSORBOARD=1, but TensorBoard does not import (%s): "
                    "metrics go to %s.jsonl only", e, filename)
            else:
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))

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
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, int(step))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """Trace the block with `torch.profiler` (the host, and the card where
    one is visible) and write it to `<log_dir>/trace.json`, a Chrome trace
    (chrome://tracing, Perfetto). Yields the profiler, or None when not
    `enabled`."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
