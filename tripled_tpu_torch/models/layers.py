"""Shared blocks (`tripled_tpu/models/layers.py`), NCHW.

Convolutions outside the ResNets keep PyTorch's default Conv2d init,
U(+-1/sqrt(fan_in)) for kernel and bias, which is what the JAX package's
`torch_conv_kernel` / `torch_conv_bias` reproduce."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5) whose running variance takes
    the biased batch variance, as flax's BatchNorm does; PyTorch's own
    update uses the unbiased one. The correction is exact algebra on the
    per-channel vectors: no second pass over the activations."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        old = self.running_var.detach().clone()
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        # torch wrote (1-m)*old + m*n/(n-1)*var; keep (1-m)*old + m*var.
        # Through .data: autograd has the buffer recorded as an input of
        # batch_norm (its backward does not read it) and would refuse a
        # version bump when a module runs twice in one step.
        m = self.momentum
        rv = self.running_var.data
        rv.copy_((1 - m) * old + (rv - (1 - m) * old) * ((n - 1) / n))
        return y


class Conv1x1(nn.Conv2d):
    def __init__(self, in_channels: int, out_channels: int, bias: bool = False):
        super().__init__(in_channels, out_channels, 1, bias=bias)


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3)

    def forward(self, x):
        return self.conv(reflect_pad(x, 1))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x):
        return F.elu(self.conv(x))


def max_pool_5x5_same(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 5, stride=1, padding=2)


class CRPBlock(nn.Module):
    """Chained residual pooling: n_stages x (5x5 max pool -> 1x1 conv),
    each stage summed into the input."""

    def __init__(self, channels: int, n_stages: int = 4):
        super().__init__()
        self.convs = nn.ModuleList(Conv1x1(channels, channels) for _ in range(n_stages))

    def forward(self, x):
        top = x
        for conv in self.convs:
            top = conv(max_pool_5x5_same(top))
            x = top + x
        return x
