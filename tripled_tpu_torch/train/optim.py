"""Optimizer and LR schedule (`tripled_tpu/train/optim.py:13-115`): the
mmcv step policy with linear warmup, global-norm clipping, Adam with
coupled L2 weight decay, and paramwise multipliers, in the order of the
JAX package's optax chain (clip -> decay -> Adam -> lr multiplier -> lr).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

from tripled_tpu_torch.config import OptimConfig


def make_lr_schedule(cfg: OptimConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step): base * gamma^(milestones passed, in epochs); during the
    first warmup_iters steps, scaled by 1 - (1 - step/W) * (1 - ratio)."""
    W = max(cfg.warmup_iters, 1)

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        regular = cfg.learning_rate * cfg.lr_gamma ** sum(epoch >= m for m in cfg.lr_steps)
        if step >= W:
            return regular
        frac = min(max(step / W, 0.0), 1.0)
        return regular * (1.0 - (1.0 - frac) * (1.0 - cfg.warmup_ratio))

    return schedule


def param_kinds(model: nn.Module) -> dict[str, list[nn.Parameter]]:
    """'norm' (BatchNorm weight and bias), 'bias' (other biases) and
    'default', the grouping the paramwise multipliers act on."""
    kinds = {"norm": [], "bias": [], "default": []}
    for module in model.modules():
        is_norm = isinstance(module, nn.modules.batchnorm._BatchNorm)
        for name, p in module.named_parameters(recurse=False):
            kind = "norm" if is_norm else "bias" if name == "bias" else "default"
            kinds[kind].append(p)
    return kinds


class Adam:
    """Adam over every parameter of `model`, frozen ones included: a
    parameter without a gradient counts as a zero gradient, as in the JAX
    step, where the frozen extractor's gradient is zero."""

    def __init__(self, model: nn.Module, cfg: OptimConfig, steps_per_epoch: int,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.cfg = cfg
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.groups = {k: v for k, v in param_kinds(model).items() if v}
        self.mu = {k: [torch.zeros_like(p) for p in ps] for k, ps in self.groups.items()}
        self.nu = {k: [torch.zeros_like(p) for p in ps] for k, ps in self.groups.items()}
        self.count = 0

    def _weight_decay(self, kind: str) -> float:
        mult = {"norm": self.cfg.norm_decay_mult, "bias": self.cfg.bias_decay_mult}
        return self.cfg.weight_decay * mult.get(kind, 1.0)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' .grad; returns the global
        norm of the gradients before clipping."""
        grads = {
            k: [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            for k, ps in self.groups.items()
        }
        flat = [g for gs in grads.values() for g in gs]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in flat]))
        max_norm = self.cfg.grad_clip_norm
        clip = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)

        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        for kind, params in self.groups.items():
            g = torch._foreach_mul(grads[kind], clip)
            wd = self._weight_decay(kind)
            if wd:
                torch._foreach_add_(g, params, alpha=wd)
            mu, nu = self.mu[kind], self.nu[kind]
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            lr_mult = self.cfg.bias_lr_mult if kind == "bias" else 1.0
            torch._foreach_add_(params, upd, alpha=-lr * lr_mult)
        return norm
