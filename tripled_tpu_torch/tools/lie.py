"""Lie algebra for SO(3)/SE(3)/Sim(3): exp/log/hat/vee.

Numpy re-implementation of the protocol in the reference's
`mono/tools/lie_algebra.py:24-181` (itself evo-derived)."""

from __future__ import annotations

import numpy as np

_EPS = 1e-10


def hat(v: np.ndarray) -> np.ndarray:
    """(3,) → skew-symmetric (3,3)."""
    x, y, z = v
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], float)


def vee(m: np.ndarray) -> np.ndarray:
    return np.array([m[2, 1], m[0, 2], m[1, 0]], float)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Axis-angle (3,) → rotation matrix (Rodrigues)."""
    theta = np.linalg.norm(w)
    if theta < _EPS:
        return np.eye(3) + hat(w)
    K = hat(w / theta)
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def so3_log(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → axis-angle (3,)."""
    cos_theta = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    if theta < _EPS:
        return vee(R - np.eye(3))
    if abs(np.pi - theta) < 1e-6:
        # near-pi: extract axis from R + I
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(A), 0))
        # fix signs via off-diagonals
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        return axis / max(np.linalg.norm(axis), _EPS) * theta
    return vee(R - R.T) / (2.0 * np.sin(theta)) * theta


def _left_jacobian(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    K = hat(w)
    if theta < _EPS:
        return np.eye(3) + 0.5 * K
    return (
        np.eye(3)
        + (1 - np.cos(theta)) / theta**2 * K
        + (theta - np.sin(theta)) / theta**3 * (K @ K)
    )


def se3_exp(xi: np.ndarray) -> np.ndarray:
    """Twist (6,) = (rho, w) → SE(3) (4,4)."""
    rho, w = np.asarray(xi[:3]), np.asarray(xi[3:])
    T = np.eye(4)
    T[:3, :3] = so3_exp(w)
    T[:3, 3] = _left_jacobian(w) @ rho
    return T


def se3_log(T: np.ndarray) -> np.ndarray:
    w = so3_log(T[:3, :3])
    Jinv = np.linalg.inv(_left_jacobian(w))
    return np.concatenate([Jinv @ T[:3, 3], w])


def sim3(r: np.ndarray, t: np.ndarray, s: float) -> np.ndarray:
    """Rotation + translation + scale → Sim(3) (4,4)."""
    T = np.eye(4)
    T[:3, :3] = s * np.asarray(r)
    T[:3, 3] = np.asarray(t)
    return T


def is_so3(R: np.ndarray, atol: float = 1e-6) -> bool:
    return (
        np.allclose(R @ R.T, np.eye(3), atol=atol)
        and abs(np.linalg.det(R) - 1.0) < atol
    )


def is_se3(T: np.ndarray, atol: float = 1e-6) -> bool:
    return is_so3(T[:3, :3], atol) and np.allclose(T[3], [0, 0, 0, 1], atol=atol)
