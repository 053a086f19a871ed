"""Image resizing (`tripled_tpu/ops/image.py`). NHWC in and out."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear", antialias=False)`: half-pixel
    centres, no antialias, in both directions."""
    if x.shape[1] == height and x.shape[2] == width:
        return x
    y = F.interpolate(_nchw(x), size=(height, width), mode="bilinear",
                      align_corners=False, antialias=False)
    return _nhwc(y)


def resize_area(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Box average for integer downscale factors, the only case the slice
    reaches (image -> 2^-s pyramid levels)."""
    b, h, w, c = x.shape
    if h == height and w == width:
        return x
    if h % height or w % width:
        raise ValueError(f"resize_area needs integer factors, got {h}x{w} -> {height}x{width}")
    fh, fw = h // height, w // width
    return x.reshape(b, height, fh, width, fw, c).mean(dim=(2, 4))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of an NCHW tensor (the decoder's upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
