"""Backward warping at pixel coordinates (`tripled_tpu/ops/warp.py:63-176`).

Bilinear sampling with border clamping: the sample point is clamped into
[0, W-1] x [0, H-1] and interpolated between its four neighbours, which
`F.grid_sample(..., padding_mode="border", align_corners=True)` computes
after normalising by (W-1, H-1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), coords (B, Ho, Wo, 2) pixel (x, y) -> (B, Ho, Wo, C)."""
    _, h, w, _ = img.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=coords.dtype,
                         device=coords.device)
    grid = coords * scale - 1.0
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)
