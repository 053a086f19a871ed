"""ColorJitter on the tensor's device from 9 floats per sample
(`tripled_tpu/ops/jitter.py`), for `DataConfig.device_color_aug`: the
loader ships the factors, and the training forward makes `color_aug` from
`color`. The formulas are `data/transforms.py`'s, in float32, with one draw
of factors and order shared by a sample's frames and the contrast mean
taken per frame.

Params (B, 9) float32: [0:4] brightness, contrast, saturation and hue
factors, [4:8] the op order (a permutation of 0..3), [8] apply; apply = 0
keeps the sample's frames as they are (the un-jittered half).

The op order differs per sample. As the JAX package's vmapped `lax.switch`
does, each of the four positions computes all four ops on the whole batch
and keeps, per sample, the one its order names (`torch.where`). A loop
over the samples would read the order on the host, which waits for the
card to finish the work queued before the call; this costs four times the
arithmetic but no synchronisation and no shape that depends on the data.
Plain PyTorch: the JAX package has no Pallas kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

# the float32 weights, as float64 numbers
_GRAY_W = tuple(float(np.float32(w)) for w in (0.299, 0.587, 0.114))


def _gray(x):
    """x @ [0.299, 0.587, 0.114] in float32, summed in the order XLA's dot
    takes (r * w0, then two fused multiply-adds, each rounded once). The
    products are exact in float64, so each step is carried there and
    rounded to float32; the same bits come out on the CPU and the card."""
    acc = (x[..., 0].double() * _GRAY_W[0]).float()
    for i in (1, 2):
        acc = (x[..., i].double() * _GRAY_W[i] + acc.double()).float()
    return acc


def _brightness(x, f):
    return torch.clamp(x * f, 0.0, 1.0)


def _contrast(x, f):
    """Blend with the grayscale mean of each frame. The mean is summed in
    float64 and rounded once to float32: the CPU and the card sum in other
    orders, and this way they give the same bits."""
    mean = _gray(x).double().mean(dim=(-2, -1), keepdim=True).float()[..., None]
    return torch.clamp(mean + (x - mean) * f, 0.0, 1.0)


def _saturation(x, f):
    gray = _gray(x)[..., None]
    return torch.clamp(gray + (x - gray) * f, 0.0, 1.0)


def _hue(x, delta):
    """The branch-free HSV round trip of `transforms.adjust_hue`; `%` is a
    floor modulo there, so `torch.remainder` here."""
    delta = delta[..., 0]  # the per-sample factor without the channel axis
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    c = maxc - minc
    s = torch.where(maxc > 0, c / torch.clamp(maxc, min=1e-12), 0.0)
    safe_c = torch.clamp(c, min=1e-12)
    h = torch.where(
        maxc == r, torch.remainder((g - b) / safe_c, 6.0),
        torch.where(maxc == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0))
    # a divide by a device tensor: CUDA turns a divide by a Python number
    # into a multiply by its reciprocal, which rounds some quotients the
    # other way than the CPU and the JAX package
    h = torch.where(c > 0, h / h.new_full((), 6.0), 0.0)
    h6 = torch.remainder(h + delta, 1.0) * 6.0
    vs = maxc * s

    def chan(n):
        k = torch.remainder(n + h6, 6.0)
        return maxc - vs * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.clamp(torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1), 0.0, 1.0)


_OPS = (_brightness, _contrast, _saturation, _hue)


def color_jitter(color: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """color (B, F, H, W, 3) float32 in [0, 1], params (B, 9) -> the
    jittered frames, (B, F, H, W, 3)."""
    per_sample = (-1,) + (1,) * (color.dim() - 1)  # (B, 1, 1, 1, 1)
    factors = [params[:, i].reshape(per_sample) for i in range(4)]
    order = params[:, 4:8].to(torch.int32)
    x = color
    for j in range(4):
        out = x
        for op_id, op in enumerate(_OPS):
            out = torch.where((order[:, j] == op_id).reshape(per_sample),
                              op(x, factors[op_id]), out)
        x = out
    return torch.where((params[:, 8] > 0).reshape(per_sample), x, color)


def sample_jitter_params(rng: np.random.RandomState, jitter, do_color_aug: bool) -> np.ndarray:
    """The (9,) float32 params of one sample, drawn from `rng` in the host
    path's order (`ColorJitter.sample`: brightness, contrast, saturation,
    hue, then the order), so that a run with the jitter on the device sees
    the host path's random stream. Without colour augmentation: identity
    factors, the order 0..3 and apply = 0."""
    if not do_color_aug:
        return np.array([1, 1, 1, 0, 0, 1, 2, 3, 0], np.float32)
    b = rng.uniform(*jitter.brightness)
    c = rng.uniform(*jitter.contrast)
    s = rng.uniform(*jitter.saturation)
    h = rng.uniform(*jitter.hue)
    order = rng.permutation(4)
    return np.concatenate([[b, c, s, h], order, [1.0]]).astype(np.float32)
