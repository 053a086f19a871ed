"""Photometric, smoothness and feature-regularisation losses
(`tripled_tpu/ops/losses.py`).

Image tensors are NHWC; per-pixel losses are (B, H, W, 1)."""

from __future__ import annotations

from typing import Sequence

import torch

from tripled_tpu_torch.ops.image import resize_area
from tripled_tpu_torch.ops.ssim import ssim
from tripled_tpu_torch.parallel.dist import global_ratio


def robust_l1(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Charbonnier |pred - target|."""
    return torch.sqrt((target - pred) ** 2 + eps * eps)


def perceptional_loss(tgt_f: torch.Tensor, src_f: torch.Tensor) -> torch.Tensor:
    """Channel-mean robust L1 between feature maps, reduced in f32."""
    return robust_l1(tgt_f, src_f).float().mean(dim=-1, keepdim=True)


def reprojection_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """0.85 * SSIM + 0.15 * robust L1, channel mean."""
    photo = robust_l1(pred, target).mean(dim=-1, keepdim=True)
    s = ssim(pred, target).mean(dim=-1, keepdim=True)
    return 0.85 * s + 0.15 * photo


def min_reprojection_with_automask(
    pred_losses: Sequence[torch.Tensor],
    identity_losses: Sequence[torch.Tensor],
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-pixel min over reprojection losses, identity losses first.

    `noise`, if given, is added to the concatenated identity losses as the
    tie-break the JAX package draws as N(0, 1e-5); the caller makes it, so
    that a test can hand both packages the same numbers. Returns (B, H, W, 1).
    """
    parts = []
    if identity_losses:
        ident = torch.cat(list(identity_losses), dim=-1)
        if noise is not None:
            ident = ident + noise
        parts.append(ident)
    parts.append(torch.cat(list(pred_losses), dim=-1))
    return torch.cat(parts, dim=-1).min(dim=-1, keepdim=True).values


def _grad_x(d):
    return d[:, :, 1:, :] - d[:, :, :-1, :]


def _grad_y(d):
    return d[:, 1:, :, :] - d[:, :-1, :, :]


def _edge_weighted(term: torch.Tensor, img_grad: torch.Tensor, a: float) -> torch.Tensor:
    if term.numel() == 0:
        # degenerate map (< 3 px along the differenced axis): the term is 0
        return torch.zeros((), dtype=term.dtype, device=term.device)
    w = torch.exp(-a * img_grad.abs().mean(dim=-1, keepdim=True))
    return (term.abs() * w).float().mean()


def _second_order_terms(d, img, a: float):
    dx, dy = _grad_x(d), _grad_y(d)
    ix, iy = _grad_x(img), _grad_y(img)
    return (
        _edge_weighted(_grad_x(dx), _grad_x(ix), a)
        + _edge_weighted(_grad_y(dx), _grad_y(ix), a)
        + _edge_weighted(_grad_x(dy), _grad_x(iy), a)
        + _edge_weighted(_grad_y(dy), _grad_y(iy), a)
    )


def smooth_loss(disp: torch.Tensor, img: torch.Tensor, a1: float = 0.5, a2: float = 0.5):
    """First- and second-order edge-aware disparity smoothness; `img` is
    area-resized to the disparity's resolution."""
    _, h, w, _ = disp.shape
    img = resize_area(img, h, w)
    dx, dy = _grad_x(disp), _grad_y(disp)
    ix, iy = _grad_x(img), _grad_y(img)
    smooth1 = _edge_weighted(dx, ix, a1) + _edge_weighted(dy, iy, a1)
    return smooth1 + _second_order_terms(disp, img, a2)


def feature_regularization_loss(feature: torch.Tensor, img: torch.Tensor, dis: float,
                                cvt: float) -> torch.Tensor:
    """-dis * first-order + cvt * second-order edge-weighted gradients of an
    encoder feature map (a = 1): the discriminative term is maximised, the
    convergent one minimised. `img` is area-resized to the feature's size
    and cast to its dtype."""
    _, h, w, _ = feature.shape
    img = resize_area(img, h, w).to(feature.dtype)
    fx, fy = _grad_x(feature), _grad_y(feature)
    ix, iy = _grad_x(img), _grad_y(img)
    smooth1 = _edge_weighted(fx, ix, 1.0) + _edge_weighted(fy, iy, 1.0)
    return -dis * smooth1 + cvt * _second_order_terms(feature, img, 1.0)


def erased_mean(loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of a per-pixel loss over the erased pixels, weighted by
    1 - mask (mask 1 = keep): sum(loss * (1 - m)) / sum(1 - m), unguarded
    as in the JAX package (a mask with nothing erased gives nan). Both sums
    run over the global batch: with more than one rank, the rank's share
    (`parallel.dist.global_ratio`)."""
    return global_ratio((loss * (1 - mask)).sum(), (1 - mask).sum())
