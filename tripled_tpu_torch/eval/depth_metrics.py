"""KITTI Eigen depth evaluation protocol (a copy of
`tripled_tpu/eval/depth_metrics.py`, numpy and PIL only).

Parity targets: the 7-metric suite `compute_errors`
(`mono/core/evaluation/pixel_error.py:7-40`) and the eval loop of
`scripts/eval_depth.py:70-108` — bilinear resize of the scale-0 disparity to
GT resolution, depth = 1/disp, Eigen crop [0.408h, 0.992h]×[0.036w, 0.964w],
median (or fixed stereo ×36) scaling, clamp to [1e-3, 80] m.
"""

from __future__ import annotations

import numpy as np

MIN_DEPTH = 1e-3
MAX_DEPTH = 80.0
STEREO_SCALE_FACTOR = 36.0


def compute_errors(gt: np.ndarray, pred: np.ndarray):
    """abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3."""
    thresh = np.maximum(gt / pred, pred / gt)
    a1 = (thresh < 1.25).mean()
    a2 = (thresh < 1.25**2).mean()
    a3 = (thresh < 1.25**3).mean()
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log = np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log, a1, a2, a3


METRIC_NAMES = ("abs_rel", "sq_rel", "rmse", "rmse_log", "a1", "a2", "a3")


def eigen_crop_mask(gt_height: int, gt_width: int) -> np.ndarray:
    crop = np.array(
        [
            0.40810811 * gt_height,
            0.99189189 * gt_height,
            0.03594771 * gt_width,
            0.96405229 * gt_width,
        ]
    ).astype(np.int32)
    m = np.zeros((gt_height, gt_width), bool)
    m[crop[0] : crop[1], crop[2] : crop[3]] = True
    return m


def _resize_bilinear_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.resize(INTER_LINEAR)-equivalent via PIL (half-pixel centers)."""
    from PIL import Image

    return np.asarray(
        Image.fromarray(img.astype(np.float32), mode="F").resize(
            (w, h), Image.BILINEAR
        )
    )


def batch_post_process_disparity(l_disp: np.ndarray, r_disp: np.ndarray):
    """Monodepth flip post-processing (`mono/datasets/utils.py:164-172`)."""
    _, h, w = l_disp.shape
    m_disp = 0.5 * (l_disp + r_disp)
    grid = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h), indexing="xy")
    l_mask = (1.0 - np.clip(20 * (grid[0] - 0.05), 0, 1))[None, ...]
    r_mask = l_mask[:, :, ::-1]
    return r_mask * l_disp + l_mask * r_disp + (1.0 - l_mask - r_mask) * m_disp


def per_image_depth_metrics(
    pred_disp,
    gt_depth,
    stereo_scale: bool = False,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
):
    """One image of the Eigen protocol: (7 errors..., median ratio) or None
    if no valid GT pixels (`scripts/eval_depth.py:82-100`)."""
    gt_depth = np.asarray(gt_depth, np.float64)
    gh, gw = gt_depth.shape[:2]
    disp = _resize_bilinear_np(np.asarray(pred_disp), gh, gw)
    pred_depth = 1.0 / np.maximum(disp, 1e-12)

    mask = (gt_depth > min_depth) & (gt_depth < max_depth)
    mask &= eigen_crop_mask(gh, gw)
    if not mask.any():
        return None
    p = pred_depth[mask]
    g = gt_depth[mask]
    ratio = np.median(g) / np.median(p)
    p = p * (STEREO_SCALE_FACTOR if stereo_scale else ratio)
    p = np.clip(p, min_depth, max_depth)
    return np.asarray(compute_errors(g, p) + (ratio,), np.float64)


def aggregate_depth_metric_rows(rows: np.ndarray):
    """(N, 8) per-image rows -> (mean 7-metrics, ratio median, ratio std)."""
    rows = np.asarray(rows, np.float64)
    ratios = rows[:, 7] if len(rows) else np.asarray([1.0])
    med = np.median(ratios)
    mean_errors = rows[:, :7].mean(0)
    return mean_errors, med, float(np.std(ratios / med))


def evaluate_depth_predictions(
    pred_disps,
    gt_depths,
    stereo_scale: bool = False,
    min_depth: float = MIN_DEPTH,
    max_depth: float = MAX_DEPTH,
):
    """Run the Eigen protocol; returns (mean 7-metrics, ratio median, ratio std)."""
    rows = [
        r
        for pred_disp, gt_depth in zip(pred_disps, gt_depths)
        if (r := per_image_depth_metrics(
            pred_disp, gt_depth, stereo_scale, min_depth, max_depth
        )) is not None
    ]
    return aggregate_depth_metric_rows(np.asarray(rows))


class AverageMeter:
    """Running average (`mono/core/evaluation/pixel_error.py` parity)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count
