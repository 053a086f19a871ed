"""KITTI raw-data helpers: calibration parsing, velodyne→depth projection,
OXTS GPS/IMU → SE(3) poses. The port's copy of
`tripled_tpu/data/kitti_utils.py`, plain numpy.

Fresh numpy implementation of the protocol in the reference's
`mono/datasets/kitti_utils.py:21-160` (itself derived from the public KITTI
devkit): project LiDAR returns through the rectified camera, round to pixel
centers with the devkit's off-by-one convention, and resolve duplicate hits
to the minimum depth.
"""

from __future__ import annotations

import os

import numpy as np


def read_calib_file(path: str) -> dict:
    """Parse a `key: v0 v1 ...` KITTI calibration file into numpy arrays."""
    data = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, value = line.split(":", 1)
            value = value.strip()
            try:
                data[key] = np.array([float(v) for v in value.split()])
            except ValueError:
                data[key] = value
    return data


def load_velodyne_points(path: str) -> np.ndarray:
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts[:, 3] = 1.0
    return pts


def velo_to_image_projection(calib_dir: str, cam: int = 2):
    """Return (P_velo2im (3,4), image_shape (H, W)) for the rectified cam."""
    cam2cam = read_calib_file(os.path.join(calib_dir, "calib_cam_to_cam.txt"))
    velo2cam_raw = read_calib_file(os.path.join(calib_dir, "calib_velo_to_cam.txt"))
    velo2cam = np.eye(4)
    velo2cam[:3, :3] = velo2cam_raw["R"].reshape(3, 3)
    velo2cam[:3, 3] = velo2cam_raw["T"]
    R_rect = np.eye(4)
    R_rect[:3, :3] = cam2cam["R_rect_00"].reshape(3, 3)
    P_rect = cam2cam[f"P_rect_0{cam}"].reshape(3, 4)
    im_shape = cam2cam["S_rect_02"][::-1].astype(np.int32)  # (H, W)
    return P_rect @ R_rect @ velo2cam, tuple(im_shape[:2])


def generate_depth_map(
    calib_dir: str, velo_filename: str, cam: int = 2, vel_depth: bool = False
) -> np.ndarray:
    """Sparse ground-truth depth map from a velodyne scan.

    Duplicate projections into the same pixel keep the minimum depth —
    implemented with a vectorized sorted scatter instead of the reference's
    per-duplicate python loop (`kitti_utils.py:92-99`).
    """
    P, (h, w) = velo_to_image_projection(calib_dir, cam)
    velo = load_velodyne_points(velo_filename)
    velo = velo[velo[:, 0] >= 0]

    pts = (P @ velo.T).T  # (N, 3)
    z = pts[:, 2]
    uv = pts[:, :2] / z[:, None]
    # devkit convention: round then -1 (matlab 1-indexing)
    u = np.round(uv[:, 0]) - 1
    v = np.round(uv[:, 1]) - 1
    depth_vals = velo[:, 0] if vel_depth else z

    valid = (u >= 0) & (v >= 0) & (u < w) & (v < h)
    u = u[valid].astype(np.int64)
    v = v[valid].astype(np.int64)
    depth_vals = depth_vals[valid]

    # min-depth scatter: sort descending so the smallest depth writes last
    order = np.argsort(-depth_vals)
    depth = np.zeros((h, w), np.float64)
    depth[v[order], u[order]] = depth_vals[order]
    depth[depth < 0] = 0
    return depth


def rotx(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def roty(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def transform_from_rot_trans(R, t) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = np.asarray(R).reshape(3, 3)
    T[:3, 3] = np.asarray(t).reshape(3)
    return T


def pose_from_oxts_packet(metadata, scale: float) -> np.ndarray:
    """OXTS (lat, lon, alt, roll, pitch, yaw) → SE(3) via Mercator projection."""
    lat, lon, alt, roll, pitch, yaw = metadata
    er = 6378137.0
    tx = scale * lon * np.pi * er / 180.0
    ty = scale * er * np.log(np.tan((90.0 + lat) * np.pi / 360.0))
    R = rotz(yaw) @ roty(pitch) @ rotx(roll)
    return transform_from_rot_trans(R, [tx, ty, alt])
