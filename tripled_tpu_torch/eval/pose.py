"""Pose / odometry evaluation utilities, the port's copy of
`tripled_tpu/eval/pose.py`, plain numpy.

Parity targets: `scripts/eval_pose.py:19-97` (5-frame-track ATE) and the
trajectory helpers in `mono/datasets/utils.py:105-122` (`dump_xyz`,
`compute_ate`)."""

from __future__ import annotations

import numpy as np


def dump_xyz(source_to_target_transformations) -> list[np.ndarray]:
    """Accumulate relative transforms into global xyz positions
    (`mono/datasets/utils.py:105-112`)."""
    xyzs = []
    cam_to_world = np.eye(4)
    xyzs.append(cam_to_world[:3, 3])
    for T in source_to_target_transformations:
        cam_to_world = np.dot(cam_to_world, T)
        xyzs.append(cam_to_world[:3, 3])
    return xyzs


def compute_ate(gtruth_xyz, pred_xyz_o) -> float:
    """Scale-aligned absolute trajectory RMSE (`utils.py:115-122`)."""
    gtruth_xyz = np.asarray(gtruth_xyz)
    pred_xyz_o = np.asarray(pred_xyz_o)
    offset = gtruth_xyz[0] - pred_xyz_o[0]
    pred_xyz = pred_xyz_o + offset[None, :]
    scale = np.sum(gtruth_xyz * pred_xyz) / np.sum(pred_xyz**2)
    alignment_error = pred_xyz * scale - gtruth_xyz
    return np.sqrt(np.sum(alignment_error**2)) / gtruth_xyz.shape[0]


def evaluate_pose_ate(
    pred_transforms: np.ndarray, gt_global_poses: np.ndarray, track_length: int = 5
):
    """5-frame-window ATE between predicted relative transforms and GT global
    poses (`scripts/eval_pose.py:64-82`). Returns (mean, std)."""
    gt_local = []
    for i in range(1, len(gt_global_poses)):
        gt_local.append(
            np.linalg.inv(gt_global_poses[i - 1]) @ gt_global_poses[i]
        )
    gt_local = np.asarray(gt_local)
    ates = []
    n = len(pred_transforms)
    for i in range(0, n - track_length + 1):
        local_xyzs = np.array(dump_xyz(pred_transforms[i : i + track_length - 1]))
        gt_xyzs = np.array(dump_xyz(gt_local[i : i + track_length - 1]))
        ates.append(compute_ate(gt_xyzs, local_xyzs))
    return float(np.mean(ates)), float(np.std(ates))


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI odometry GT pose file: each line is a flattened 3×4 matrix."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    n = raw.shape[0]
    poses = np.tile(np.eye(4), (n, 1, 1))
    poses[:, :3, :] = raw
    return poses


def save_kitti_poses(path: str, poses) -> None:
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in np.asarray(T)[:3, :].reshape(-1)))
            f.write("\n")


def accumulate_global_poses(pred_transforms) -> np.ndarray:
    """`draw_odometry.py:62-74`: global_pose ← global_pose @ inv(T)."""
    global_pose = np.eye(4)
    out = [global_pose.copy()]
    for T in pred_transforms:
        global_pose = global_pose @ np.linalg.inv(np.asarray(T))
        out.append(global_pose.copy())
    return np.asarray(out)
