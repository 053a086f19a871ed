"""Depth evaluator for the training loop's eval hook and the eval CLI
(`tripled_tpu/eval/evaluator.py`), in one process: every image of the
dataset, in batches of `batch_size` (the last one padded by repeating its
last image), then the per-image Eigen protocol on the host."""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

from tripled_tpu_torch.eval.depth_metrics import (
    METRIC_NAMES,
    aggregate_depth_metric_rows,
    batch_post_process_disparity,
    per_image_depth_metrics,
)


class DepthEvaluator:
    def __init__(
        self,
        predict_fn: Callable,  # images (B, 1, H, W, 3) -> scaled disparity (B, h, w, 1)
        dataset,
        batch_size: int = 8,
        stereo_scale: bool = False,
        flip_post_process: bool = False,
        device="cuda",
    ):
        self.predict_fn = predict_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.stereo_scale = stereo_scale
        self.flip_post_process = flip_post_process
        self.device = torch.device(device)

    def _predict(self, images: torch.Tensor) -> np.ndarray:
        return self.predict_fn(images)[..., 0].cpu().numpy()

    def _collect_disps(self, indices):
        bs = self.batch_size
        disps = []
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=4) as pool:
            for start in range(0, len(indices), bs):
                idx = indices[start:start + bs]
                pad = bs - len(idx)
                # one RandomState per index: deterministic whatever the pool's order
                samples = list(pool.map(
                    lambda i: self.dataset.sample(i, np.random.RandomState(i)), idx))
                imgs = np.stack([s["color"] for s in samples])  # (b, 1, H, W, 3)
                if pad:
                    imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
                imgs = torch.from_numpy(imgs).to(self.device)
                disp = self._predict(imgs)
                if self.flip_post_process:
                    disp_f = self._predict(imgs.flip(3))
                    disp = batch_post_process_disparity(disp, disp_f[:, :, ::-1])
                if pad:
                    disp = disp[:-pad]
                disps.extend(list(disp))
        dt = time.perf_counter() - t0
        # end to end: decode, copy to the card, predict, copy back
        fps = len(indices) / dt if dt > 0 else float("inf")
        return disps, fps

    def run(self) -> dict:
        """The 7 Eigen metrics, the scale ratios' median and spread, and
        eval_fps (images/s of the whole loop)."""
        indices = list(range(len(self.dataset)))
        disps, fps = self._collect_disps(indices)
        rows = [r for i, d in zip(indices, disps)
                if (r := per_image_depth_metrics(d, self.dataset.gt_depths[i],
                                                 stereo_scale=self.stereo_scale)) is not None]
        rows = np.stack(rows) if rows else np.zeros((0, 8), np.float64)
        mean_errors, ratio_med, ratio_std = aggregate_depth_metric_rows(rows)
        metrics = dict(zip(METRIC_NAMES, [float(x) for x in mean_errors]))
        metrics["scale_ratio_med"] = float(ratio_med)
        metrics["scale_ratio_std"] = float(ratio_std)
        metrics["eval_fps"] = float(fps)
        return metrics
