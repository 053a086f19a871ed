"""Train and predict steps (`tripled_tpu/train/step.py:37-105`)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops.geometry import disp_to_depth
from tripled_tpu_torch.train.optim import Adam


def make_train_step(model: TripleDNet, optimizer: Adam) -> Callable:
    """step(batch, generator=None) -> metrics: every loss_dict entry, `loss`
    (their sum) and `grad_norm` (before clipping), as 0-d tensors.
    `generator` draws the decoder's dropout."""

    def train_step(batch: Dict[str, torch.Tensor], generator: torch.Generator | None = None):
        model.train()
        _, loss_dict = model(batch, generator)
        total = sum(loss_dict.values())
        model.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = total.detach()
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_predict_fn(model: TripleDNet) -> Callable:
    """Eval-mode prediction: images (B, 1, H, W, 3) -> scale-0 scaled
    disparity (B, h, w, 1), whose inverse is the depth."""
    cfg = model.cfg

    @torch.no_grad()
    def predict(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        disps = model({"color_aug": images, "color": images})
        scaled, _ = disp_to_depth(disps[0], cfg.min_depth, cfg.max_depth)
        return scaled

    return predict
