"""Trajectory containers & alignment (reference `mono/tools/trajectory.py` /
`geometry.py` — evo-derived Umeyama alignment)."""

from __future__ import annotations

import numpy as np


def align_umeyama(model: np.ndarray, data: np.ndarray, known_scale=False):
    """Least-squares similarity transform aligning `data` onto `model`.

    Args: (N, 3) point sets. Returns (s, R, t) with model ≈ s·R·data + t.
    Umeyama (1991); parity with `mono/tools/geometry.py:20-67`.
    """
    mu_M = model.mean(0)
    mu_D = data.mean(0)
    model_zc = model - mu_M
    data_zc = data - mu_D
    n = model.shape[0]
    C = (model_zc.T @ data_zc) / n
    sigma2 = (data_zc**2).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0 if known_scale else float(np.trace(np.diag(D) @ S) / sigma2)
    t = mu_M - s * R @ mu_D
    return s, R, t


def align_trajectory(p_gt: np.ndarray, p_es: np.ndarray, method="sim3", n=-1):
    """Align estimated positions to GT: method ∈ {'sim3','se3','posyaw'}.

    Returns (s, R, t). Parity with `mono/tools/trajectory.py` align paths.
    """
    idx = slice(None) if n < 0 else slice(0, n)
    gt, es = p_gt[idx], p_es[idx]
    if method == "sim3":
        return align_umeyama(gt, es, known_scale=False)
    if method == "se3":
        return align_umeyama(gt, es, known_scale=True)
    if method == "posyaw":
        # yaw-only rotation + translation, unit scale
        g = gt - gt.mean(0)
        e = es - es.mean(0)
        C = g[:, :2].T @ e[:, :2]
        theta = np.arctan2(C[0, 1] - C[1, 0], C[0, 0] + C[1, 1])
        R = np.array(
            [
                [np.cos(theta), -np.sin(theta), 0],
                [np.sin(theta), np.cos(theta), 0],
                [0, 0, 1],
            ]
        )
        t = gt.mean(0) - R @ es.mean(0)
        return 1.0, R, t
    raise ValueError(method)


class PosePath3D:
    """Minimal evo-style pose path: positions + SE(3) poses with stats."""

    def __init__(self, poses_se3: np.ndarray):
        self.poses = np.asarray(poses_se3)

    @property
    def positions(self) -> np.ndarray:
        return self.poses[:, :3, 3]

    @property
    def distances(self) -> np.ndarray:
        d = np.linalg.norm(np.diff(self.positions, axis=0), axis=1)
        return np.concatenate([[0.0], np.cumsum(d)])

    def transform(self, T: np.ndarray, scale: float = 1.0) -> "PosePath3D":
        out = self.poses.copy()
        out[:, :3, 3] *= scale
        return PosePath3D(np.einsum("ij,njk->nik", T, out))

    def ape_rmse(self, other: "PosePath3D") -> float:
        diff = self.positions - other.positions
        return float(np.sqrt((diff**2).sum(-1).mean()))
