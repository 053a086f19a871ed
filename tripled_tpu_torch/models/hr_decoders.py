"""HR-Depth and DIFFNet disparity decoders (`tripled_tpu/models/hr_decoders.py`),
NCHW. Each returns four sigmoid disparities, scale 0 at the input's full
resolution (the CRP decoder's is at half), each (B, 1, h, w). Neither takes
dropout nor recomputes its activations under `remat`: the JAX package wraps
only the CRP decoder. flax infers the input widths; here they are computed
from `num_ch_enc`."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tripled_tpu_torch.models.layers import AttentionModule, Conv1x1, Conv3x3, ConvBlock, FSEModule
from tripled_tpu_torch.ops.image import upsample2x_nearest

DEC_CH = (16, 32, 64, 128, 256)
# the nested grid's positions "{row}{column}" in the order they are computed;
# the fSE positions fuse by attention, the others by concatenation
_POSITIONS = ("01", "11", "21", "31", "02", "12", "22", "03", "13", "04")
_ATTENTION = {"31", "22", "13", "04"}


class HRDepthDecoder(nn.Module):
    """HR-Depth's nested decoder. Position (row, col) upsamples a ConvBlock
    of (row + 1, col - 1) and fuses it with (row, 0 .. col - 1): by fSE at
    31, 22, 13 and 04; elsewhere by concatenation, a 1x1 reduction to
    twice the row's decoder width past column 1, and a ConvBlock. Then two
    ConvBlocks around a last upsample, and heads on that, 04, 13 and 22.
    The modules are kept in the JAX module's creation order (`blocks`,
    `reduces`, `fse`, `heads`), which names its variables."""

    def __init__(self, num_ch_enc: Sequence[int], num_ch_dec: Sequence[int] = DEC_CH,
                 num_output_channels: int = 1):
        super().__init__()
        enc, dec = list(num_ch_enc), list(num_ch_dec)

        def conv0_out(i, j):  # a ConvBlock's width on (i, j) before it goes up
            ch = enc[i] // 2 if i == 0 and j != 0 else enc[i]
            return max(ch // 2, 1)

        ch = {f"{i}0": c for i, c in enumerate(enc)}
        blocks, reduces, fse = [], [], []
        self.plan = []  # per position: (index, its high ConvBlock, its fusion)
        for index in _POSITIONS:
            row, col = int(index[0]), int(index[1])
            high_ch = conv0_out(row + 1, col - 1)
            blocks.append(ConvBlock(ch[f"{row + 1}{col - 1}"], high_ch))
            high = len(blocks) - 1
            cin = high_ch + sum(ch[f"{row}{i}"] for i in range(col))
            if index in _ATTENTION:
                fse.append(FSEModule(cin, high_ch))
                self.plan.append((index, high, ("fse", len(fse) - 1)))
                ch[index] = high_ch
                continue
            reduce = None
            if col != 1:
                reduces.append(Conv1x1(cin, dec[row + 1] * 2))
                reduce, cin = len(reduces) - 1, dec[row + 1] * 2
            blocks.append(ConvBlock(cin, dec[row + 1]))
            self.plan.append((index, high, ("merge", len(blocks) - 1, reduce)))
            ch[index] = dec[row + 1]
        last = conv0_out(0, 4)
        blocks += [ConvBlock(ch["04"], last), ConvBlock(last, dec[0])]
        self.blocks = nn.ModuleList(blocks)
        self.reduces = nn.ModuleList(reduces)
        self.fse = nn.ModuleList(fse)
        self.heads = nn.ModuleList(Conv3x3(c, num_output_channels)
                                   for c in (dec[0], ch["04"], ch["13"], ch["22"]))

    def forward(self, features, generator=None):
        """`generator` is not read: the decoder has no dropout."""
        feats = {f"{i}0": f for i, f in enumerate(features)}
        for index, high, fusion in self.plan:
            row, col = int(index[0]), int(index[1])
            lows = [feats[f"{row}{i}"] for i in range(col)]
            x = self.blocks[high](feats[f"{row + 1}{col - 1}"])
            if fusion[0] == "fse":
                feats[index] = self.fse[fusion[1]](x, lows)
                continue
            x = torch.cat([upsample2x_nearest(x)] + lows, dim=1)
            if fusion[2] is not None:
                x = self.reduces[fusion[2]](x)
            feats[index] = self.blocks[fusion[1]](x)
        x = self.blocks[-1](upsample2x_nearest(self.blocks[-2](feats["04"])))
        return [torch.sigmoid(head(t)) for head, t in
                zip(self.heads, (x, feats["04"], feats["13"], feats["22"]))]


class DIFFDepthDecoder(nn.Module):
    """DIFFNet's decoder over HRNet's nested features [stem (64), list18
    (conv2's 64 channels, then three of width w), list36 (three of 2w),
    list72 (two of 4w), f144 (8w)]: four attention fusions of the
    upsampled deeper result with a whole per-width list (72 -> 256, 36 ->
    128, 18 -> 64, then the stem -> 32), two ConvBlocks around a last
    upsample, and heads on that and the 32-, 64- and 128-channel results."""

    def __init__(self, num_ch_enc: Sequence[int], num_ch_dec: Sequence[int] = DEC_CH,
                 num_output_channels: int = 1):
        super().__init__()
        stem, w1, w2, w4, w8 = num_ch_enc
        self.attention = nn.ModuleList([
            AttentionModule(w8 + 2 * w4, 256), AttentionModule(256 + 3 * w2, 128),
            AttentionModule(128 + stem + 3 * w1, 64), AttentionModule(64 + stem, 32)])
        self.blocks = nn.ModuleList([ConvBlock(32, num_ch_dec[0]),
                                     ConvBlock(num_ch_dec[0], num_ch_dec[0])])
        self.heads = nn.ModuleList(Conv3x3(c, num_output_channels)
                                   for c in (num_ch_dec[0], 32, 64, 128))

    def forward(self, features, generator=None):
        """`generator` is not read: the decoder has no dropout."""
        f64, list18, list36, list72, f144 = features
        x72 = self.attention[0](f144, list72)
        x36 = self.attention[1](x72, list36)
        x18 = self.attention[2](x36, list18)
        x9 = self.attention[3](x18, [f64])
        x6 = self.blocks[1](upsample2x_nearest(self.blocks[0](x9)))
        return [torch.sigmoid(head(t)) for head, t in zip(self.heads, (x6, x9, x18, x36))]
