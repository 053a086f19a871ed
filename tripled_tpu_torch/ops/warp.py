"""Backward warping at pixel coordinates (`tripled_tpu/ops/warp.py:63-176`).

Bilinear sampling with border clamping: the sample point is clamped into
[0, W-1] x [0, H-1] and interpolated between its four neighbours, which
`F.grid_sample(..., padding_mode="border", align_corners=True)` computes
after normalising by (W-1, H-1). Nearest sampling takes the texel at
floor(x + 0.5), clamped into the image, as the JAX package rounds: a
coordinate exactly halfway between two texels takes the upper one, where
`F.grid_sample(mode="nearest")` would round half to even."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(img: torch.Tensor, coords: torch.Tensor, method: str = "bilinear") -> torch.Tensor:
    """img (B, H, W, C), coords (B, Ho, Wo, 2) pixel (x, y) -> (B, Ho, Wo, C),
    interpolated in the wider of the two dtypes: a bf16 image's texels with
    float32 coordinates interpolate in float32, as the JAX warp's
    bf16 * f32 weights promote. `method` "nearest" gathers the nearest
    texel of img as it is."""
    if method == "nearest":
        return _nearest(img, coords)
    img = img.to(torch.promote_types(img.dtype, coords.dtype))
    _, h, w, _ = img.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=coords.dtype,
                         device=coords.device)
    grid = coords * scale - 1.0
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def _nearest(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    _, ho, wo, _ = coords.shape
    xi = torch.floor(coords[..., 0] + 0.5).clamp(0, w - 1).long()
    yi = torch.floor(coords[..., 1] + 0.5).clamp(0, h - 1).long()
    index = (yi * w + xi).reshape(b, ho * wo, 1).expand(b, ho * wo, c)
    return img.reshape(b, h * w, c).gather(1, index).reshape(b, ho, wo, c)
