"""Camera geometry for view synthesis (`tripled_tpu/ops/geometry.py`).

Images are NHWC; depth is (B, H, W) or (B, H, W, 1); K and T are (B, 4, 4).
"""

from __future__ import annotations

import torch


def pixel_grid(height: int, width: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Homogeneous pixel grid, shape (3, H*W): rows are x, y, 1."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij",
    )
    ones = torch.ones(height * width, dtype=dtype, device=device)
    return torch.stack([xs.reshape(-1), ys.reshape(-1), ones], dim=0)


def _squeeze_depth(depth: torch.Tensor) -> torch.Tensor:
    return depth[..., 0] if depth.dim() == 4 else depth


def backproject(depth: torch.Tensor, inv_K: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W[, 1]) -> homogeneous camera points (B, 4, H*W)."""
    depth = _squeeze_depth(depth)
    b, h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    cam = torch.matmul(inv_K[:, :3, :3], pix) * depth.reshape(b, 1, h * w)
    ones = torch.ones(b, 1, h * w, dtype=depth.dtype, device=depth.device)
    return torch.cat([cam, ones], dim=1)


def project(points, K, T, height: int, width: int, eps: float = 1e-7,
            normalized: bool = False) -> torch.Tensor:
    """Homogeneous points (B, 4, H*W) -> source-view pixel coords (B, H, W, 2)."""
    P = torch.matmul(K, T)[:, :3, :]
    cam = torch.matmul(P, points)
    pix = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    b = points.shape[0]
    pix = pix.reshape(b, 2, height, width).permute(0, 2, 3, 1)
    if normalized:
        scale = torch.tensor([width - 1, height - 1], dtype=pix.dtype, device=pix.device)
        pix = (pix / scale - 0.5) * 2.0
    return pix


def warp_coords(depth, inv_K, K, T, eps: float = 1e-7) -> torch.Tensor:
    """Fused backproject -> project: target pixel -> source pixel coords
    (B, H, W, 2), through one (B, 3, 3) matrix on the rays plus the
    translation column."""
    depth = _squeeze_depth(depth)
    b, h, w = depth.shape
    pix = pixel_grid(h, w, depth.dtype, depth.device)
    P = torch.matmul(K, T)[:, :3, :]
    M = torch.matmul(P[:, :, :3], inv_K[:, :3, :3])
    rays = torch.matmul(M, pix)
    cam = rays * depth.reshape(b, 1, h * w) + P[:, :, 3:4]
    xy = cam[:, :2, :] / (cam[:, 2:3, :] + eps)
    return xy.reshape(b, 2, h, w).permute(0, 2, 3, 1)


def disp_to_depth(disp, min_depth: float, max_depth: float):
    """Sigmoid disparity -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def rot_from_axisangle(vec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (B, 1, 3) -> rotation matrix (B, 4, 4) (Rodrigues)."""
    angle = torch.linalg.norm(vec, dim=2, keepdim=True)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[:, 0, 0]
    sa = torch.sin(angle)[:, 0, 0]
    C = 1.0 - ca
    x, y, z = axis[:, 0, 0], axis[:, 0, 1], axis[:, 0, 2]
    xs, ys, zs = x * sa, y * sa, z * sa
    xC, yC, zC = x * C, y * C, z * C
    xyC, yzC, zxC = x * yC, y * zC, z * xC
    zero = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    return torch.stack(
        [
            x * xC + ca, xyC - zs, zxC + ys, zero,
            xyC + zs, y * yC + ca, yzC - xs, zero,
            zxC - ys, yzC + xs, z * zC + ca, zero,
            zero, zero, zero, one,
        ],
        dim=-1,
    ).reshape(-1, 4, 4)


def get_translation_matrix(t: torch.Tensor) -> torch.Tensor:
    """(B, 3) or (B, 1, 3) translation -> (B, 4, 4)."""
    t = t.reshape(-1, 3)
    T = torch.eye(4, dtype=t.dtype, device=t.device).repeat(t.shape[0], 1, 1)
    T[:, :3, 3] = t
    return T


def transformation_from_parameters(axisangle, translation, invert: bool = False):
    """Axis-angle + translation -> SE(3) (B, 4, 4); `invert` composes the
    inverse transform for backward-in-time frames."""
    R = rot_from_axisangle(axisangle.reshape(-1, 1, 3))
    t = translation.reshape(-1, 3)
    if invert:
        R = R.transpose(1, 2)
        t = -t
    T = get_translation_matrix(t)
    return torch.matmul(R, T) if invert else torch.matmul(T, R)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a 4x4 pinhole intrinsics matrix."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    inv = torch.stack(
        [
            1.0 / fx, zeros, -cx / fx, zeros,
            zeros, 1.0 / fy, -cy / fy, zeros,
            zeros, zeros, ones, zeros,
            zeros, zeros, zeros, ones,
        ],
        dim=-1,
    )
    return inv.reshape(K.shape)


def scale_intrinsics(K: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Scale rows 0 (x) and 1 (y) of K."""
    row_scale = torch.tensor([sx, sy, 1.0, 1.0], dtype=K.dtype, device=K.device)
    return K * row_scale.reshape((1,) * (K.dim() - 2) + (4, 1))
