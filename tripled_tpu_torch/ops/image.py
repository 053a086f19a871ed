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


def _linear_aa_weights(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(..., "linear",
    antialias=True)` along one axis (jax's `compute_weight_mat`): a
    triangle filter at half-pixel centres, stretched by the downscale
    factor, each output's weights normalised to sum 1."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=dtype, device=device) + 0.5) * inv_scale - 0.5
    dist = sample[None, :] - torch.arange(n_in, dtype=dtype, device=device)[:, None]
    w = (1 - dist.abs() / max(inv_scale, 1.0)).clamp_min(0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_area(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Box average for integer downscale factors (image -> 2^-s pyramid
    levels); otherwise, as the JAX package, antialiased linear resampling
    (`jax.image.resize(..., "linear", antialias=True)`), here two small
    matrix products. The rotation pretext reaches it: the full target
    against a crop's feature sizes. (F.interpolate's antialiased bilinear
    mode computes the same weights, but its CUDA kernel refuses large
    factors such as 1024 -> 112.)"""
    b, h, w, c = x.shape
    if h == height and w == width:
        return x
    if h % height or w % width:
        wh = _linear_aa_weights(h, height, x.dtype, x.device)
        ww = _linear_aa_weights(w, width, x.dtype, x.device)
        return torch.einsum("bowc,wp->bopc", torch.einsum("bhwc,ho->bowc", x, wh), ww)
    fh, fw = h // height, w // width
    return x.reshape(b, height, fh, width, fw, c).mean(dim=(2, 4))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of an NCHW tensor (the decoder's upsample)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
