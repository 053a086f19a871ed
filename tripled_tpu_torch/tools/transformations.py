"""Quaternion / euler / matrix conversions.

Fresh numpy implementations of the subset of the vendored Gohlke library the
reference actually uses (`mono/tools/transformations.py` via
`pose_evaluation_utils.py`): quaternion↔matrix, euler↔matrix/quaternion.
Quaternions are (w, x, y, z); euler order is 'sxyz' (static roll-pitch-yaw).
"""

from __future__ import annotations

import numpy as np


def quaternion_from_matrix(M: np.ndarray) -> np.ndarray:
    R = np.asarray(M, float)[:3, :3]
    t = np.trace(R)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        w = 0.25 / s
        x = (R[2, 1] - R[1, 2]) * s
        y = (R[0, 2] - R[2, 0]) * s
        z = (R[1, 0] - R[0, 1]) * s
    else:
        i = int(np.argmax(np.diag(R)))
        if i == 0:
            s = 2.0 * np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2])
            w = (R[2, 1] - R[1, 2]) / s
            x = 0.25 * s
            y = (R[0, 1] + R[1, 0]) / s
            z = (R[0, 2] + R[2, 0]) / s
        elif i == 1:
            s = 2.0 * np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2])
            w = (R[0, 2] - R[2, 0]) / s
            x = (R[0, 1] + R[1, 0]) / s
            y = 0.25 * s
            z = (R[1, 2] + R[2, 1]) / s
        else:
            s = 2.0 * np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1])
            w = (R[1, 0] - R[0, 1]) / s
            x = (R[0, 2] + R[2, 0]) / s
            y = (R[1, 2] + R[2, 1]) / s
            z = 0.25 * s
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quaternion_matrix(q: np.ndarray) -> np.ndarray:
    w, x, y, z = np.asarray(q, float) / np.linalg.norm(q)
    T = np.eye(4)
    T[:3, :3] = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )
    return T


def euler_matrix(roll: float, pitch: float, yaw: float) -> np.ndarray:
    """'sxyz' euler → (4,4): R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    return T


def euler_from_matrix(M: np.ndarray):
    """(4,4) or (3,3) → (roll, pitch, yaw), 'sxyz'."""
    R = np.asarray(M, float)[:3, :3]
    pitch = np.arcsin(np.clip(-R[2, 0], -1.0, 1.0))
    if abs(np.cos(pitch)) > 1e-8:
        roll = np.arctan2(R[2, 1], R[2, 2])
        yaw = np.arctan2(R[1, 0], R[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-R[1, 2], R[1, 1])
        yaw = 0.0
    return roll, pitch, yaw


def euler_from_matrix_szxy(M: np.ndarray):
    """Gohlke euler_from_matrix(M, axes='szxy') — the convention the
    reference's odometry RPY plot uses (`kitti_evaluation_toolkit.py:270`).
    axes tuple (2, 0, 0, 0): i=2, j=0, k=1, parity=0, frame=0."""
    R = np.asarray(M, float)[:3, :3]
    cy = np.sqrt(R[2, 2] * R[2, 2] + R[0, 2] * R[0, 2])
    if cy > 1e-8:
        ax = np.arctan2(R[1, 0], R[1, 1])
        ay = np.arctan2(-R[1, 2], cy)
        az = np.arctan2(R[0, 2], R[2, 2])
    else:
        ax = np.arctan2(-R[0, 1], R[0, 0])
        ay = np.arctan2(-R[1, 2], cy)
        az = 0.0
    return ax, ay, az


def quaternion_from_euler(roll, pitch, yaw) -> np.ndarray:
    return quaternion_from_matrix(euler_matrix(roll, pitch, yaw))


def euler_from_quaternion(q):
    return euler_from_matrix(quaternion_matrix(q))
