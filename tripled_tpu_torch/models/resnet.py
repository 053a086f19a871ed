"""Five-stage ResNet feature pyramid (`tripled_tpu/models/resnet.py`), NCHW.

Returns [relu1, layer1, layer2, layer3, layer4] at strides 2..32, each
stage optionally plus an additive conditioning feature. Convs start from
kaiming-normal (fan_out), truncated at two standard deviations, as
`kaiming_out` in the JAX package draws them."""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.models.layers import _TRUNC_STD, BatchNorm, Conv2d, conv_bn, remat

BLOCK_COUNTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def stage_channels(num_layers: int) -> tuple[int, ...]:
    return (64, 256, 512, 1024, 2048) if num_layers > 34 else (64, 64, 128, 256, 512)


def _conv(cin, cout, k, stride=1):
    conv = Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    fan_out = cout * k * k
    std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
    return conv


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN layers and, with `use_residual`, the residual add.
    Without a downsample the residual is the input as it is: a 1-channel
    input broadcasts over the output's channels, as in the JAX block (the
    grayscale distillation head)."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False,
                 use_residual: bool = True):
        super().__init__()
        self.use_residual = use_residual
        self.conv1 = _conv(cin, planes, 3, stride)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3)
        self.bn2 = BatchNorm(planes)
        self.downsample = (
            nn.Sequential(_conv(cin, planes, 1, stride), BatchNorm(planes)) if downsample else None
        )

    def convs_and_bns(self):
        """Convs and BNs in the JAX module's creation order."""
        convs, bns = [self.conv1, self.conv2], [self.bn1, self.bn2]
        if self.downsample is not None:
            convs.append(self.downsample[0])
            bns.append(self.downsample[1])
        return convs, bns

    def forward(self, x):
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = conv_bn(self.conv2, self.bn2, out)
        residual = x if self.downsample is None else conv_bn(*self.downsample, x)
        return F.relu(out + residual if self.use_residual else out)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm(planes)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(cin, planes * 4, 1, stride), BatchNorm(planes * 4))
            if downsample else None
        )

    def convs_and_bns(self):
        convs = [self.conv1, self.conv2, self.conv3]
        bns = [self.bn1, self.bn2, self.bn3]
        if self.downsample is not None:
            convs.append(self.downsample[0])
            bns.append(self.downsample[1])
        return convs, bns

    def forward(self, x):
        out = F.relu(conv_bn(self.conv1, self.bn1, x))
        out = F.relu(conv_bn(self.conv2, self.bn2, out))
        out = conv_bn(self.conv3, self.bn3, out)
        residual = x if self.downsample is None else conv_bn(*self.downsample, x)
        return F.relu(out + residual)


class ResNetFeatures(nn.Module):
    def __init__(self, num_layers: int = 18, in_channels: int = 3, remat: bool = False):
        super().__init__()
        self.remat = remat
        block = Bottleneck if num_layers > 34 else BasicBlock
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.bn1 = BatchNorm(64)
        stages = []
        cin, planes = 64, 64
        for stage_idx, n_blocks in enumerate(BLOCK_COUNTS[num_layers]):
            stride = 1 if stage_idx == 0 else 2
            blocks = []
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or cin != planes * block.expansion)
                blocks.append(block(cin, planes, s, downsample=ds))
                cin = planes * block.expansion
            stages.append(nn.Sequential(*blocks))
            planes *= 2
        self.layers = nn.ModuleList(stages)

    def _graph_part(self, x, graph_stages: int, cond):
        """The stem and stages 1 .. graph_stages-1; returns their features
        and the next stage's input."""
        x = _plus(F.relu(conv_bn(self.conv1, self.bn1, x)), cond, 0)
        feats = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for i, stage in enumerate(self.layers[:graph_stages - 1], start=1):
            x = _plus(stage(x), cond, i)
            feats.append(x)
        return feats, x

    def forward(self, x, graph_stages: int = 5, cond_features=None):
        """The five stages' features; with `cond_features` (five tensors of
        the stages' shapes) each stage's output is summed with its own
        before it is stored and fed on. Stages past the first
        `graph_stages` (the stem counts as the first) run without an
        autograd graph: their outputs carry no gradient, but their
        BatchNorm layers still update the running statistics. With `remat`,
        the part with a graph is recomputed in the backward; the rest keeps
        nothing to recompute."""
        graph_stages = max(graph_stages, 1)
        feats, x = remat(self._graph_part, x, graph_stages, cond_features, enabled=self.remat)
        with torch.no_grad():
            for i, stage in enumerate(self.layers[graph_stages - 1:], start=graph_stages):
                x = _plus(stage(x), cond_features, i)
                feats.append(x)
        return feats


def _plus(x, cond, i: int):
    return x if cond is None else x + cond[i]
