"""Image resizing (`tripled_tpu/ops/image.py`). NHWC in and out, but for
the network-internal upsamples (`upsample2x_nearest`,
`resize_bilinear_align_corners`), which take NCHW."""

from __future__ import annotations

import functools

import numpy as np
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


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(n_in: int, n_out: int, dtype, device) -> torch.Tensor:
    """(n_out, n_in) weights of bilinear resampling with align_corners=True:
    output i samples input i * (n_in - 1) / (n_out - 1). As the JAX package
    computes them under jit (`tripled_tpu/ops/image.py:27-43`): in float32
    whatever `dtype`, the matrix cast after; and XLA folds the division
    into a multiplication by one float32 constant, f32(n_in - 1) times
    f32(1 / (n_out - 1)), which moves some positions by an ulp (and their
    weights by up to 1e-6) from the divided ones. F.interpolate in float64
    computes float64 positions, about 1e-8 away. Built once per sizes,
    dtype and device (HRNet resamples 31 times a forward), and never
    written to."""
    f32 = torch.float32
    if n_out == 1 or n_in == 1:
        pos = torch.zeros(n_out, dtype=f32, device=device)
    else:
        step = np.float32(n_in - 1) * (np.float32(1) / np.float32(n_out - 1))
        pos = torch.arange(n_out, dtype=f32, device=device) * torch.tensor(step, device=device)
    lo = pos.floor().clamp(0, n_in - 1).long()
    hi = (lo + 1).clamp_max(n_in - 1)
    frac = pos - lo.to(f32)
    rows = torch.arange(n_out, device=device)
    m = torch.zeros(n_out, n_in, dtype=f32, device=device)
    m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    m.index_put_((rows, hi), frac, accumulate=True)
    return m.to(dtype)


def resize_bilinear_align_corners(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resampling of an NCHW tensor with align_corners=True (the
    HRNet fuse upsample), as two small matrix products."""
    if x.shape[2] == height and x.shape[3] == width:
        return x
    mh = _align_corners_matrix(x.shape[2], height, x.dtype, x.device)
    mw = _align_corners_matrix(x.shape[3], width, x.dtype, x.device)
    return torch.einsum("bcow,pw->bcop", torch.einsum("oh,bchw->bcow", mh, x), mw)


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
