"""Trajectory file IO: TUM / KITTI / EuRoC formats + timestamp association
(reference `mono/tools/file_interface.py:31-382` / `pose_evaluation_utils.py`).
"""

from __future__ import annotations

import csv

import numpy as np

from tripled_tpu_torch.tools.transformations import quaternion_from_matrix, quaternion_matrix


def read_tum_trajectory(path: str):
    """TUM: `t x y z qx qy qz qw` → (timestamps (N,), poses (N,4,4))."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            t, x, y, z, qx, qy, qz, qw = vals[:8]
            T = quaternion_matrix([qw, qx, qy, qz])
            T[:3, 3] = [x, y, z]
            stamps.append(t)
            poses.append(T)
    return np.asarray(stamps), np.asarray(poses)


def write_tum_trajectory(path: str, stamps, poses):
    with open(path, "w") as f:
        for t, T in zip(stamps, poses):
            q = quaternion_from_matrix(T)
            x, y, z = T[:3, 3]
            f.write(
                f"{t:.6f} {x:.6f} {y:.6f} {z:.6f} "
                f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n"
            )


def read_kitti_poses(path: str) -> np.ndarray:
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (raw.shape[0], 1, 1))
    poses[:, :3, :] = raw
    return poses


def write_kitti_poses(path: str, poses):
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in np.asarray(T)[:3].reshape(-1)))
            f.write("\n")


def read_euroc_trajectory(path: str):
    """EuRoC ground-truth CSV: ns timestamp, position, quaternion (w first)."""
    stamps, poses = [], []
    with open(path) as f:
        reader = csv.reader(f)
        for row in reader:
            if not row or row[0].startswith("#"):
                continue
            t = float(row[0]) * 1e-9
            x, y, z = map(float, row[1:4])
            qw, qx, qy, qz = map(float, row[4:8])
            T = quaternion_matrix([qw, qx, qy, qz])
            T[:3, 3] = [x, y, z]
            stamps.append(t)
            poses.append(T)
    return np.asarray(stamps), np.asarray(poses)


def associate_timestamps(stamps_a, stamps_b, max_diff: float = 0.02):
    """Greedy nearest-neighbor association (evo/TUM-tools protocol).

    Returns index pairs (i, j) with |a[i] - b[j]| <= max_diff.
    """
    stamps_a = np.asarray(stamps_a)
    stamps_b = np.asarray(stamps_b)
    pairs = []
    used_b = set()
    for i, ta in enumerate(stamps_a):
        j = int(np.argmin(np.abs(stamps_b - ta)))
        if j in used_b:
            continue
        if abs(stamps_b[j] - ta) <= max_diff:
            pairs.append((i, j))
            used_b.add(j)
    return pairs
