"""HRNet multi-resolution encoder for the DIFFNet depth path
(`tripled_tpu/models/hrnet.py`), NCHW.

Stem (two stride-2 3x3 conv-BN-ReLU), layer1 (four Bottlenecks to 256
channels), then stages 2-4 with 1, 4 and 3 modules over 2, 3 and 4
branches of widths w, 2w, 4w, 8w: a transition gives each new branch a
stride-2 3x3 conv of the previous stage's last branch (an old branch whose
width changes a stride-1 one), and each module runs four BasicBlocks per
branch, then fuses every branch into every other: a 1x1 conv, BatchNorm and
bilinear align-corners upsample from a coarser branch, a chain of stride-2
3x3 conv-BNs (ReLU between) from a finer one, summed and ReLU'd.

Returns the nested DIFFNet features [stem (64 ch, stride 2), list18
(conv2's output, 64 ch, then branch 0 after stages 2, 3, 4), list36
(branch 1 after stages 2, 3, 4), list72 (branch 2 after stages 3, 4),
branch 3 (8w ch, stride 32)]. The input is the raw [0, 1] image: nothing
normalises it. Convs start from kaiming-normal (fan-out, truncated) as
the ResNets'; BatchNorm is the ResNets' too (momentum 0.1, eps 1e-5, biased
running variance), which is what the JAX module's own flax BatchNorm
computes. The JAX module ignores `remat`, and so does this one: nothing here
recomputes its activations."""

from __future__ import annotations

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.models.layers import BatchNorm, conv_bn
from tripled_tpu_torch.models.resnet import BasicBlock, Bottleneck, _conv
from tripled_tpu_torch.ops.image import resize_bilinear_align_corners

# modules in stages 2, 3, 4, the same at every width
_STAGE_MODULES = {2: 1, 3: 4, 4: 3}
_BLOCKS_PER_BRANCH = 4


class ConvBN(nn.Module):
    """A bias-free k x k convolution (zero padding k // 2) and BatchNorm."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.conv = _conv(cin, cout, k, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return conv_bn(self.conv, self.bn, x)


class _FuseLayer(nn.Module):
    """Every branch i receives every other branch j at its resolution;
    `paths` lists the (i, j) paths in the JAX module's creation order (i
    outer, j inner), each a list of ConvBNs."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        n = len(widths)
        self.pairs = [(i, j) for i in range(n) for j in range(n) if j != i]
        self.paths = nn.ModuleList()
        for i, j in self.pairs:
            if j > i:
                chain = [ConvBN(widths[j], widths[i], 1)]
            else:
                chain = [ConvBN(widths[j], widths[i] if k == i - j - 1 else widths[j], 3, 2)
                         for k in range(i - j)]
            self.paths.append(nn.ModuleList(chain))

    def forward(self, xs):
        acc = list(xs)
        for (i, j), chain in zip(self.pairs, self.paths):
            y = xs[j]
            for k, layer in enumerate(chain):
                y = layer(y)
                if j < i and k < len(chain) - 1:
                    y = F.relu(y)
            if j > i:
                y = resize_bilinear_align_corners(y, xs[i].shape[2], xs[i].shape[3])
            acc[i] = acc[i] + y
        return [F.relu(a) for a in acc]


class _HRModule(nn.Module):
    """Four BasicBlocks on each branch, then the fuse layer."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w, w) for _ in range(_BLOCKS_PER_BRANCH))) for w in widths)
        self.fuse = _FuseLayer(widths) if len(widths) > 1 else None

    def forward(self, xs):
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        return ys if self.fuse is None else self.fuse(ys)


class HRNetFeatures(nn.Module):
    def __init__(self, width: int = 18):
        super().__init__()
        w = width
        self.num_ch_enc = (64, w, 2 * w, 4 * w, 8 * w)
        self.stem = nn.ModuleList([ConvBN(3, 64, 3, 2), ConvBN(64, 64, 3, 2)])
        self.layer1 = nn.Sequential(*(Bottleneck(64 if b == 0 else 256, 64, downsample=b == 0)
                                      for b in range(4)))
        # per stage, per branch: None where the branch passes as it is, else
        # (ConvBN, whether it reads the previous stage's last branch)
        self.transitions = nn.ModuleList()
        self.transition_plan = []
        self.stages = nn.ModuleList()
        prev = [256]
        for stage in (2, 3, 4):
            widths = [w * 2**i for i in range(stage)]
            layers, plan = nn.ModuleList(), []
            for i, tw in enumerate(widths):
                if i < len(prev):
                    if prev[i] == tw:
                        plan.append(None)
                        continue
                    layers.append(ConvBN(prev[i], tw, 3))
                    plan.append((len(layers) - 1, False))
                else:
                    layers.append(ConvBN(prev[-1], tw, 3, 2))
                    plan.append((len(layers) - 1, True))
            self.transitions.append(layers)
            self.transition_plan.append(plan)
            self.stages.append(nn.ModuleList(_HRModule(widths)
                                             for _ in range(_STAGE_MODULES[stage])))
            prev = widths

    def conv_bns(self):
        """The top-level ConvBNs in the JAX module's creation order (its
        Conv_k / BatchNorm_k)."""
        return list(self.stem) + [m for layers in self.transitions for m in layers]

    def forward(self, x):
        x = F.relu(self.stem[0](x))
        stem = x
        x = F.relu(self.stem[1](x))
        list18, list36, list72 = [x], [], []
        branches = [self.layer1(x)]
        for layers, plan, modules in zip(self.transitions, self.transition_plan, self.stages):
            new = []
            for i, step in enumerate(plan):
                if step is None:
                    new.append(branches[i])
                else:
                    index, from_last = step
                    new.append(F.relu(layers[index](branches[-1] if from_last else branches[i])))
            branches = new
            for module in modules:
                branches = module(branches)
            list18.append(branches[0])
            list36.append(branches[1])
            if len(branches) >= 3:
                list72.append(branches[2])
        return [stem, list18, list36, list72, branches[3]]
