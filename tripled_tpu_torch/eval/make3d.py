"""Make3D central-crop evaluation protocol (`scripts/eval_make3D.py:21-101`),
the port's copy of `tripled_tpu/eval/make3d.py`: center-crop the
2272-px-tall images to 852 px (2:1 aspect), run @640×192, median-scale,
cap at 70 m, C1 metrics (abs_rel, sq_rel, rmse, log10-rmse). The depth
map goes to PIL as a float32 array, which PIL opens in mode "F" without
the `mode` argument that recent Pillow deprecates: the same pixels."""

from __future__ import annotations

import os

import numpy as np


def make3d_errors(gt: np.ndarray, pred: np.ndarray):
    rmse = np.sqrt(((gt - pred) ** 2).mean())
    rmse_log10 = np.sqrt(((np.log10(gt) - np.log10(pred)) ** 2).mean())
    abs_rel = (np.abs(gt - pred) / gt).mean()
    sq_rel = (((gt - pred) ** 2) / gt).mean()
    return abs_rel, sq_rel, rmse, rmse_log10


def load_make3d(main_path: str):
    """Yield (image float [0,1] HWC RGB center-cropped, gt depth (21, 305))."""
    import scipy.io
    from PIL import Image

    color_new_height = 1704 // 2
    test_dir = os.path.join(main_path, "Test134")
    for fn in sorted(os.listdir(test_dir)):
        if not fn.endswith(".jpg"):
            continue
        stem = fn[4:-4]
        mat = scipy.io.loadmat(
            os.path.join(main_path, "Gridlaserdata", f"depth_sph_corr-{stem}.mat")
        )
        gt = mat["Position3DGrid"][:, :, 3]
        gt_cropped = gt[(55 - 21) // 2 : (55 + 21) // 2, :]
        img = np.asarray(Image.open(os.path.join(test_dir, fn)), np.float32) / 255.0
        top = (2272 - color_new_height) // 2
        img = img[top : top + color_new_height]
        yield img, gt_cropped


def evaluate_make3d(predict_disp, main_path: str, height=192, width=640):
    """predict_disp: (1, H, W, 3) float32 numpy -> scale-0 disp (1, h, w, 1)."""
    from PIL import Image

    errors = []
    for img, gt in load_make3d(main_path):
        im = Image.fromarray((img * 255).astype(np.uint8)).resize(
            (width, height), Image.BILINEAR
        )
        x = (np.asarray(im, np.float32) / 255.0)[None]
        disp = np.asarray(predict_disp(x))[0, ..., 0]
        depth = 1.0 / np.maximum(disp, 1e-12)
        dep = np.asarray(
            Image.fromarray(depth.astype(np.float32)).resize(
                (gt.shape[1], gt.shape[0]), Image.NEAREST
            )
        )
        mask = (gt > 0) & (gt < 70)
        g, p = gt[mask], dep[mask]
        p *= np.median(g) / np.median(p)
        p[p > 70] = 70
        errors.append(make3d_errors(g, p))
    return np.mean(errors, 0)
