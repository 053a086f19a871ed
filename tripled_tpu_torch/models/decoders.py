"""Image-reconstruction decoders (`tripled_tpu/models/decoders.py`), NCHW.

`ImageDecoder`: five levels of ConvBlock -> 2x nearest upsample -> iconv
ConvBlock, fed only by the deepest encoder stage, with sigmoid image heads
on iconv4..iconv1. `ColorDecoder`: the same trunk, plus each scale's
disparity added to its iconv (`iconv + resize(disp) * multiplier`) and
optional additive skips from the encoder stages. Both return images
[scale0, scale1, scale2, scale3], scale 0 at the input resolution, each
(B, out_channels, h, w). With `remat`, a decoder's activations are
recomputed in the backward."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tripled_tpu_torch.models.layers import Conv3x3, ConvBlock, remat
from tripled_tpu_torch.ops.image import resize_bilinear, upsample2x_nearest

DEC_CH = (16, 32, 64, 128, 256)


class _Trunk(nn.Module):
    """Per level 4..0: `upconvs[i]` (ConvBlock, then 2x upsample) and
    `iconvs[i]` (ConvBlock)."""

    def __init__(self, in_channels: int, remat: bool = False):
        super().__init__()
        self.remat = remat
        ins = (in_channels,) + DEC_CH[:0:-1]  # 4 -> 0: in, 256, 128, 64, 32
        outs = DEC_CH[::-1]
        self.upconvs = nn.ModuleList(ConvBlock(i, o) for i, o in zip(ins, outs))
        self.iconvs = nn.ModuleList(ConvBlock(o, o) for o in outs)


class ImageDecoder(_Trunk):
    def __init__(self, in_channels: int, num_output_channels: int = 3, remat: bool = False):
        super().__init__(in_channels, remat)
        # heads on iconv4..iconv1, i.e. scales 3..0
        self.heads = nn.ModuleList(Conv3x3(c, num_output_channels) for c in DEC_CH[3::-1])

    def forward(self, features):
        return remat(self._decode, features[4], enabled=self.remat)

    def _decode(self, x):
        iconvs = []
        for up, iconv in zip(self.upconvs, self.iconvs):
            x = iconv(upsample2x_nearest(up(x)))
            iconvs.append(x)  # iconv5..iconv1
        outs = [torch.sigmoid(head(x)) for head, x in zip(self.heads, iconvs[1:])]
        return outs[::-1]


class ColorDecoder(_Trunk):
    def __init__(self, num_ch_enc: Sequence[int], num_output_channels: int = 3,
                 skip_connection_multiplier: float = 1.0,
                 skip_layers: Sequence[bool] = (False, False, False, False),
                 remat: bool = False):
        super().__init__(num_ch_enc[4], remat)
        self.multiplier = skip_connection_multiplier
        # skips[j] adds encoder stage 3 - j to level 3 - j's upsampled input
        self.skips = nn.ModuleList(
            ConvBlock(num_ch_enc[3 - j], DEC_CH[3 - j]) if flag else nn.Identity()
            for j, flag in enumerate(skip_layers))
        self.skip_layers = tuple(bool(f) for f in skip_layers)
        # heads on iconv1..iconv4, i.e. scales 0..3
        self.heads = nn.ModuleList(Conv3x3(c, num_output_channels) for c in DEC_CH[:4])

    def forward(self, features, disps):
        """features: the 5-stage pyramid (NCHW); disps: [s0, s1, s2, s3],
        each (B, 1, h, w)."""
        return remat(self._decode, features, disps, enabled=self.remat)

    def _decode(self, features, disps):
        x = features[4]
        iconvs = []
        for level, (up, iconv) in enumerate(zip(self.upconvs, self.iconvs)):
            x = upsample2x_nearest(up(x))
            if level > 0 and self.skip_layers[level - 1]:
                x = x + upsample2x_nearest(self.skips[level - 1](features[4 - level]))
            x = iconv(x)
            if level < 4:  # iconv5..iconv2 take disparities s3..s0
                d = resize_bilinear(disps[3 - level].permute(0, 2, 3, 1), x.shape[2], x.shape[3])
                x = x + d.permute(0, 3, 1, 2) * self.multiplier
            iconvs.append(x)
        return [torch.sigmoid(head(x)) for head, x in zip(self.heads, iconvs[::-1])]
