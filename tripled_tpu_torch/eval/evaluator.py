"""Depth evaluator for the training loop's eval hook and the eval CLI
(`tripled_tpu/eval/evaluator.py`): the images in batches of `batch_size`
(the last one padded by repeating its last image), then the per-image
Eigen protocol on the host. With more than one rank (`parallel.dist`)
each rank evaluates `range(rank, n, world)`, as the reference's eval hook
and the JAX evaluator do, and the per-image metric rows, NaN-padded to a
common count, are gathered to every rank before the aggregate."""

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
from tripled_tpu_torch.parallel import dist


class DepthEvaluator:
    def __init__(
        self,
        predict_fn: Callable,  # images (B, 1, H, W, 3) -> scaled disparity (B, h, w, 1)
        dataset,
        batch_size: int = 8,
        stereo_scale: bool = False,
        flip_post_process: bool = False,
        device="cuda",
        shard_across_processes: bool = True,
    ):
        self.predict_fn = predict_fn
        self.dataset = dataset
        self.batch_size = batch_size
        self.stereo_scale = stereo_scale
        self.flip_post_process = flip_post_process
        self.device = torch.device(device)
        self.shard_across_processes = shard_across_processes

    def _shard(self):
        if not self.shard_across_processes:
            return 0, 1
        return dist.rank(), dist.world_size()

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
        p_idx, p_cnt = self._shard()
        n = len(self.dataset)
        indices = list(range(p_idx, n, p_cnt))
        disps, fps = self._collect_disps(indices)
        rows = [r for i, d in zip(indices, disps)
                if (r := per_image_depth_metrics(d, self.dataset.gt_depths[i],
                                                 stereo_scale=self.stereo_scale)) is not None]
        rows = np.stack(rows) if rows else np.zeros((0, 8), np.float64)
        if p_cnt > 1:
            rows = self._allgather_rows(rows, n, p_cnt)
        mean_errors, ratio_med, ratio_std = aggregate_depth_metric_rows(rows)
        metrics = dict(zip(METRIC_NAMES, [float(x) for x in mean_errors]))
        metrics["scale_ratio_med"] = float(ratio_med)
        metrics["scale_ratio_std"] = float(ratio_std)
        metrics["eval_fps"] = float(fps)
        return metrics

    def _allgather_rows(self, rows: np.ndarray, n_total: int, p_cnt: int) -> np.ndarray:
        """Every rank's rows, in rank order: each rank's NaN-padded to the
        most a rank can hold, gathered on the evaluator's device (NCCL
        gathers CUDA tensors only), the padding dropped."""
        max_local = -(-n_total // p_cnt)
        padded = np.full((max_local, rows.shape[1]), np.nan, np.float64)
        padded[:len(rows)] = rows
        gathered = dist.gather_rows(torch.from_numpy(padded).to(self.device)[None])
        gathered = gathered.cpu().numpy().reshape(-1, rows.shape[1])
        return gathered[~np.isnan(gathered[:, 0])]
