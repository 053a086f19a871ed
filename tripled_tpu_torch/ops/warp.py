"""Backward warping at pixel coordinates (`tripled_tpu/ops/warp.py`).

Bilinear sampling with border clamping: the sample point is clamped into
[0, W-1] x [0, H-1] and interpolated between its four neighbours, which
`F.grid_sample(..., padding_mode="border", align_corners=True)` computes
after normalising by (W-1, H-1). Nearest sampling takes the texel at
floor(x + 0.5), clamped into the image, as the JAX package rounds: a
coordinate exactly halfway between two texels takes the upper one, where
`F.grid_sample(mode="nearest")` would round half to even.

The block warp (`grid_sample_block`) is the JAX package's output-block
gather. There each block of output pixels gathers one source patch and
interpolates inside it, a sample beyond the patch clamped to its edge; the
patch, its lane padding and its byte cap served the TPU's gather engine.
The numbers equal the exact warp's at coordinates clamped into each
block's patch, which is what this module computes: an elementwise clamp,
then `grid_sample`."""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F


def _pad64_cap() -> int:
    """The JAX package's byte cap on its padded patch tensor, read from the
    same environment variable, so that both packages choose alike."""
    return int(os.environ.get("TRIPLED_WARP_PAD64_CAP", 10**9))


def grid_sample(img: torch.Tensor, coords: torch.Tensor, method: str = "bilinear",
                gather_dtype: torch.dtype | None = None) -> torch.Tensor:
    """img (B, H, W, C), coords (B, Ho, Wo, 2) pixel (x, y) -> (B, Ho, Wo, C),
    interpolated in the wider of the two dtypes: a bf16 image's texels with
    float32 coordinates interpolate in float32, as the JAX warp's
    bf16 * f32 weights promote. `gather_dtype` (bilinear only) rounds the
    texels to it first, as the JAX package rounds its gathered corners.
    `method` "nearest" gathers the nearest texel of img as it is."""
    if method == "nearest":
        return _nearest(img, coords)
    if gather_dtype is not None and gather_dtype != img.dtype:
        img = img.to(gather_dtype).to(img.dtype)
    img = img.to(torch.promote_types(img.dtype, coords.dtype))
    _, h, w, _ = img.shape
    scale = torch.tensor([2.0 / (w - 1), 2.0 / (h - 1)], dtype=coords.dtype,
                         device=coords.device)
    grid = coords * scale - 1.0
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.permute(0, 2, 3, 1)


def grid_sample_block(img: torch.Tensor, coords: torch.Tensor,
                      gather_dtype: torch.dtype | None = None,
                      block: tuple[int, int] = (2, 2)) -> torch.Tensor:
    """The bilinear warp of `grid_sample` in bh x bw blocks of output pixels
    (`tripled_tpu/ops/warp.py:178-284`): each block samples inside the
    (bh+2) x (bw+2) source patch anchored at the floor of its smallest
    (border-clamped) coordinate, the anchor kept inside the image; a sample
    beyond the patch is clamped to its edge, along each axis alone. Exact
    wherever a block's samples spread less than the patch. The anchor takes
    no gradient. Needs Ho % bh == 0 and Wo % bw == 0 (the caller takes the
    exact warp otherwise).

    A block other than (2, 2) falls back to (2, 2) where the JAX package's
    would: when its patch rows, padded to 64 or 128 lanes, would exceed the
    byte cap (`TRIPLED_WARP_PAD64_CAP`, 1e9 bytes by default)."""
    b, h, w, c = img.shape
    _, ho, wo, _ = coords.shape
    bh, bw = block
    py, px = bh + 2, bw + 2  # the patch's sides
    if (bh, bw) != (2, 2):
        pc = py * px * c
        pad_to = 64 if pc <= 64 else (128 if pc <= 128 else pc)
        itemsize = (gather_dtype or img.dtype).itemsize
        if pc < pad_to and b * h * w * pad_to * itemsize > _pad64_cap():
            return grid_sample_block(img, coords, gather_dtype=gather_dtype, block=(2, 2))
    x = coords[..., 0].clamp(0.0, w - 1.0).reshape(b, ho // bh, bh, wo // bw, bw)
    y = coords[..., 1].clamp(0.0, h - 1.0).reshape(b, ho // bh, bh, wo // bw, bw)
    xa = torch.floor(x.detach().amin(dim=(2, 4), keepdim=True)).clamp(0, w - px)
    ya = torch.floor(y.detach().amin(dim=(2, 4), keepdim=True)).clamp(0, h - py)
    x = xa + (x - xa).clamp(0.0, px - 1.0)
    y = ya + (y - ya).clamp(0.0, py - 1.0)
    clamped = torch.stack([x.reshape(b, ho, wo), y.reshape(b, ho, wo)], dim=-1)
    return grid_sample(img, clamped, gather_dtype=gather_dtype)


def _nearest(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    b, h, w, c = img.shape
    _, ho, wo, _ = coords.shape
    xi = torch.floor(coords[..., 0] + 0.5).clamp(0, w - 1).long()
    yi = torch.floor(coords[..., 1] + 0.5).clamp(0, h - 1).long()
    index = (yi * w + xi).reshape(b, ho * wo, 1).expand(b, ho * wo, c)
    return img.reshape(b, h * w, c).gather(1, index).reshape(b, ho, wo, c)
