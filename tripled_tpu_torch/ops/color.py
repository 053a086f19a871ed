"""Differentiable colour-space conversions, RGB <-> Lab and grayscale
(`tripled_tpu/ops/color.py`), for the grayscale and colorization
distillation heads. NHWC, RGB in [0, 1]; Lab normalised as
((L - 50) / 50, a / 110, b / 110).

Every divide is a true divide on every device: CUDA turns a divide by a
Python number into a multiply by its reciprocal, which rounds some
quotients the other way, so each divisor here is a 0-d tensor on the
input's device. The three-term dot products (the RGB-XYZ matrices and
the grayscale weights) take XLA's order: a product, then two fused
multiply-adds, each rounded once; in float32 each step is carried in
float64, where the products are exact, so that the port gives the JAX
package's bits on the CPU and the same bits on the card. `jnp.cbrt`
becomes `pow(t, 1/3)` on t clamped to at least 1e-12 (PyTorch has no
cube root); the tests state its gap.
"""

from __future__ import annotations

import numpy as np
import torch

_WHITE = (0.95047, 1.0, 1.08883)

# Rec.601 luma weights, as torchvision.transforms.Grayscale
_GRAY_W = (0.299, 0.587, 0.114)

_RGB2XYZ = ((0.412453, 0.357580, 0.180423),
            (0.212671, 0.715160, 0.072169),
            (0.019334, 0.119193, 0.950227))
_XYZ2RGB = ((3.24048134, -1.53715152, -0.49853633),
            (-0.96925495, 1.87599, 0.04155593),
            (0.05564664, -0.20404134, 1.05731107))


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / x.new_full((), d)


def _dot3(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w over the last axis (of 3) of x, for 3 Python numbers w."""
    if x.dtype != torch.float32:
        return x[..., 0] * w[0] + x[..., 1] * w[1] + x[..., 2] * w[2]
    w = [float(np.float32(v)) for v in w]  # the weights as JAX holds them
    acc = (x[..., 0].double() * w[0]).float()
    for i in (1, 2):
        acc = (x[..., i].double() * w[i] + acc.double()).float()
    return acc


def _matvec(x: torch.Tensor, m) -> torch.Tensor:
    """x @ m.T over the last axis of x, for a 3x3 m of Python numbers."""
    return torch.stack([_dot3(x, row) for row in m], dim=-1)


def _srgb_to_linear(rgb: torch.Tensor) -> torch.Tensor:
    return torch.where(rgb > 0.04045, torch.pow(_div(rgb + 0.055, 1.055), 2.4),
                       _div(rgb, 12.92))


def _linear_to_srgb(rgb: torch.Tensor) -> torch.Tensor:
    rgb = torch.clamp(rgb, min=0.0)
    return torch.where(rgb > 0.0031308, 1.055 * torch.pow(rgb, 1.0 / 2.4) - 0.055,
                       12.92 * rgb)


def rgb2xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _matvec(_srgb_to_linear(rgb), _RGB2XYZ)


def xyz2rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _linear_to_srgb(_matvec(xyz, _XYZ2RGB))


def _f_cbrt(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > 0.008856, torch.pow(torch.clamp(t, min=1e-12), 1.0 / 3.0),
                       7.787 * t + 16.0 / 116.0)


def xyz2lab(xyz: torch.Tensor) -> torch.Tensor:
    t = _f_cbrt(xyz / torch.tensor(_WHITE, dtype=xyz.dtype, device=xyz.device))
    L = 116.0 * t[..., 1] - 16.0
    a = 500.0 * (t[..., 0] - t[..., 1])
    b = 200.0 * (t[..., 1] - t[..., 2])
    return torch.stack([L, a, b], dim=-1)


def lab2xyz(lab: torch.Tensor) -> torch.Tensor:
    y = _div(lab[..., 0] + 16.0, 116.0)
    x = _div(lab[..., 1], 500.0) + y
    z = torch.clamp(y - _div(lab[..., 2], 200.0), min=0.0)
    t = torch.stack([x, y, z], dim=-1)
    t = torch.where(t > 0.2068966, t * t * t, _div(t - 16.0 / 116.0, 7.787))
    return t * torch.tensor(_WHITE, dtype=lab.dtype, device=lab.device)


def rgb2lab(rgb: torch.Tensor, l_cent: float = 50.0, l_norm: float = 50.0,
            ab_norm: float = 110.0) -> torch.Tensor:
    """RGB [0, 1] -> normalised Lab: ((L - l_cent) / l_norm, a / ab_norm,
    b / ab_norm)."""
    lab = xyz2lab(rgb2xyz(rgb))
    L = _div(lab[..., 0:1] - l_cent, l_norm)
    ab = _div(lab[..., 1:], ab_norm)
    return torch.cat([L, ab], dim=-1)


def lab2rgb(lab_rs: torch.Tensor, l_cent: float = 50.0, l_norm: float = 50.0,
            ab_norm: float = 110.0) -> torch.Tensor:
    L = lab_rs[..., 0:1] * l_norm + l_cent
    ab = lab_rs[..., 1:] * ab_norm
    return xyz2rgb(lab2xyz(torch.cat([L, ab], dim=-1)))


def rgb_to_l(rgb: torch.Tensor) -> torch.Tensor:
    """The L channel of Lab, scaled to [0, 1]."""
    lin = _srgb_to_linear(rgb)
    y = 0.212671 * lin[..., 0] + 0.715160 * lin[..., 1] + 0.072169 * lin[..., 2]
    L = 116.0 * _f_cbrt(y) - 16.0
    return _div(L[..., None], 100.0)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.601 grayscale, as torchvision's Grayscale(num_output_channels=1)."""
    return _dot3(rgb, _GRAY_W)[..., None]
