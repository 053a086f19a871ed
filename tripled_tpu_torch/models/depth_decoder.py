"""CRP depth decoder (`tripled_tpu/models/depth_decoder.py`), NCHW.

Per level: 1x1 reduce, 3x3 iconv over cat(reduce, up(prev), prev_disp),
leaky ReLU, CRP x4, 3x3 merge, leaky ReLU, 2x nearest upsample, sigmoid
disparity head. Dropout on the two deepest encoder stages in training.
Returns disparities [scale0, scale1, scale2, scale3] at 1/2 .. 1/16 of the
input resolution, each (B, 1, h, w)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.models.layers import CRPBlock, Conv1x1, Conv3x3
from tripled_tpu_torch.ops.image import upsample2x_nearest


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (keep with prob 1 - rate)."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


class _Level(nn.Module):
    def __init__(self, feat_ch: int, reduce_ch: int, in_ch: int, bottleneck: int):
        super().__init__()
        self.reduce = Conv1x1(feat_ch, reduce_ch)
        self.iconv = Conv3x3(in_ch, bottleneck)
        self.crp = CRPBlock(bottleneck, 4)
        self.merge = Conv3x3(bottleneck, bottleneck)
        self.disp = Conv3x3(bottleneck, 1)

    def forward(self, feat, prev=None, prev_disp=None):
        x = self.reduce(feat)
        if prev is not None:
            x = torch.cat([x, prev, prev_disp], dim=1)
        x = F.leaky_relu(self.iconv(x))
        x = self.crp(x)
        x = F.leaky_relu(self.merge(x))
        x = upsample2x_nearest(x)
        return x, torch.sigmoid(self.disp(x))


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], bottleneck: int = 256,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.dropout_rate = dropout_rate
        bn = bottleneck
        # levels run from the deepest stage (4) up to stage 1
        self.levels = nn.ModuleList([
            _Level(num_ch_enc[4], 512, 512, bn),
            _Level(num_ch_enc[3], bn, 2 * bn + 1, bn),
            _Level(num_ch_enc[2], bn, 2 * bn + 1, bn),
            _Level(num_ch_enc[1], bn, 2 * bn + 1, bn),
        ])

    def forward(self, features, generator: torch.Generator | None = None):
        _, l1, l2, l3, l4 = features
        if self.training and self.dropout_rate > 0:
            l4 = dropout(l4, self.dropout_rate, generator)
            l3 = dropout(l3, self.dropout_rate, generator)
        x, disp = self.levels[0](l4)
        disps = [disp]
        for level, feat in zip(self.levels[1:], (l3, l2, l1)):
            x, disp = level(feat, x, disp)
            disps.append(disp)
        return disps[::-1]
