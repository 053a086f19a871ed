"""CRP depth decoder (`tripled_tpu/models/depth_decoder.py`), NCHW.

Per level: 1x1 reduce, 3x3 iconv over cat(reduce, up(prev), prev_disp),
leaky ReLU, CRP x4, 3x3 merge, leaky ReLU, 2x nearest upsample (or with
`use_shuffle` a pixel shuffle, `layers.UpShuffle`), sigmoid disparity
head. Dropout on the two deepest encoder stages in training. With
`eqmask_pool` the CRP pools take the equality-mask backward
(`layers.max_pool_5x5_same_eqmask`, `ModelConfig.pool_eqmask_grad`).
Returns disparities [scale0, scale1, scale2, scale3] at 1/2 .. 1/16 of the
input resolution, each (B, 1, h, w). With `remat`, the levels' activations
are recomputed in the backward; the dropout masks are drawn before, once."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.models.layers import CRPBlock, Conv1x1, Conv3x3, UpShuffle, remat
from tripled_tpu_torch.ops.image import upsample2x_nearest
from tripled_tpu_torch.parallel.dist import rank_rows, world_size


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout drawn from `generator` (keep with prob 1 - rate).
    The uniform is float32 whatever x's dtype: bf16's 8-bit mantissa would
    shift the keep probability. It is drawn at the global batch's shape,
    and each rank keeps its rows (`parallel.dist.rank_rows`): R ranks drop
    what one process drops on the same frames."""
    keep = 1.0 - rate
    shape = (x.shape[0] * world_size(), *x.shape[1:])
    u = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32)
    mask = rank_rows(u) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """Slope 0.01 in x's dtype, as the JAX package's weakly typed constant:
    in bf16, bf16(0.01) = 0.010009765625."""
    return F.leaky_relu(x, 0.010009765625 if x.dtype == torch.bfloat16 else 0.01)


class _Level(nn.Module):
    def __init__(self, feat_ch: int, reduce_ch: int, in_ch: int, bottleneck: int,
                 eqmask_pool: bool = False):
        super().__init__()
        self.reduce = Conv1x1(feat_ch, reduce_ch)
        self.iconv = Conv3x3(in_ch, bottleneck)
        self.crp = CRPBlock(bottleneck, 4, eqmask_pool=eqmask_pool)
        self.merge = Conv3x3(bottleneck, bottleneck)
        self.disp = Conv3x3(bottleneck, 1)

    def forward(self, up, feat, prev=None, prev_disp=None):
        x = self.reduce(feat)
        if prev is not None:
            x = torch.cat([x, prev, prev_disp], dim=1)
        x = leaky_relu(self.iconv(x))
        x = self.crp(x)
        x = leaky_relu(self.merge(x))
        x = up(x)
        return x, torch.sigmoid(self.disp(x))


class DepthDecoder(nn.Module):
    def __init__(self, num_ch_enc: Sequence[int], bottleneck: int = 256,
                 dropout_rate: float = 0.5, remat: bool = False, use_shuffle: bool = False,
                 eqmask_pool: bool = False):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.remat = remat
        bn = bottleneck
        # levels run from the deepest stage (4) up to stage 1
        self.levels = nn.ModuleList([
            _Level(num_ch_enc[4], 512, 512, bn, eqmask_pool),
            _Level(num_ch_enc[3], bn, 2 * bn + 1, bn, eqmask_pool),
            _Level(num_ch_enc[2], bn, 2 * bn + 1, bn, eqmask_pool),
            _Level(num_ch_enc[1], bn, 2 * bn + 1, bn, eqmask_pool),
        ])
        ups = [upsample2x_nearest] * 4
        if use_shuffle:
            # three shuffles, the third shared by levels 2 and 1: the JAX
            # package keeps the reference's reuse of its level-2 shuffle
            # (`tripled_tpu/models/depth_decoder.py:41-49`)
            self.shuffles = nn.ModuleList(UpShuffle(bn, bn) for _ in range(3))
            ups = [self.shuffles[0], self.shuffles[1], self.shuffles[2], self.shuffles[2]]
        self._ups = ups

    def forward(self, features, generator: torch.Generator | None = None):
        _, l1, l2, l3, l4 = features
        if self.training and self.dropout_rate > 0:
            # outside the recomputed part: a recompute must not draw again
            l4 = dropout(l4, self.dropout_rate, generator)
            l3 = dropout(l3, self.dropout_rate, generator)
        return remat(self._decode, l1, l2, l3, l4, enabled=self.remat)

    def _decode(self, l1, l2, l3, l4):
        x, disp = self.levels[0](self._ups[0], l4)
        disps = [disp]
        for level, up, feat in zip(self.levels[1:], self._ups[1:], (l3, l2, l1)):
            x, disp = level(up, feat, x, disp)
            disps.append(disp)
        return disps[::-1]
