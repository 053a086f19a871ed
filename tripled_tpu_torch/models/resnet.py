"""Five-stage ResNet feature pyramid (`tripled_tpu/models/resnet.py`), NCHW.

Returns [relu1, layer1, layer2, layer3, layer4] at strides 2..32. Convs
start from kaiming-normal (fan_out), truncated at two standard deviations,
as `kaiming_out` in the JAX package draws them."""

from __future__ import annotations

import math

import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.models.layers import BatchNorm

BLOCK_COUNTS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def stage_channels(num_layers: int) -> tuple[int, ...]:
    return (64, 256, 512, 1024, 2048) if num_layers > 34 else (64, 64, 128, 256, 512)


def _conv(cin, cout, k, stride=1):
    conv = nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)
    fan_out = cout * k * k
    std = math.sqrt(2.0 / fan_out) / _TRUNC_STD
    nn.init.trunc_normal_(conv.weight, std=std, a=-2 * std, b=2 * std)
    return conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
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
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


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
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetFeatures(nn.Module):
    def __init__(self, num_layers: int = 18, in_channels: int = 3):
        super().__init__()
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

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        feats = [x]
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for stage in self.layers:
            x = stage(x)
            feats.append(x)
        return feats
