"""SSIM dissimilarity (`tripled_tpu/ops/ssim.py:23-45`): reflect pad 1,
3x3 box filter, C1 = 1e-4, C2 = 9e-4, output clamp((1 - SSIM) / 2, 0, 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_C1 = 0.01**2
_C2 = 0.03**2


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """SSIM dissimilarity map, NHWC in and out."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    yp = F.pad(y.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def box3(t):
        return F.avg_pool2d(t, 3, stride=1)

    mu_x = box3(xp)
    mu_y = box3(yp)
    sigma_x = box3(xp * xp) - mu_x * mu_x
    sigma_y = box3(yp * yp) - mu_y * mu_y
    sigma_xy = box3(xp * yp) - mu_x * mu_y

    n = (2 * mu_x * mu_y + _C1) * (2 * sigma_xy + _C2)
    d = (mu_x * mu_x + mu_y * mu_y + _C1) * (sigma_x + sigma_y + _C2)
    return torch.clamp((1.0 - n / d) * 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
