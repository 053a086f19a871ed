"""Load the JAX package's variables into the port's modules.

`params` and `batch_stats` are the JAX package's trees as nested dicts of
numpy arrays. Conv kernels go from HWIO to OIHW; flax BatchNorm
`scale`/`bias`/`mean`/`var` go to `weight`/`bias`/`running_mean`/
`running_var`. Every key is consumed and every tensor of the module is
written: a missing key, a leftover key or an unwritten tensor raises.
Trees of a `remat=True` JAX model load too: there `nn.remat` names each
encoder's ResNet `CheckpointResNetFeatures_0` instead of `ResNetFeatures_0`.
A `compute_dtype="bfloat16"` model keeps float32 variables, which load as
they are. The disentangle split (`depth_skips`) has no variables. The
distillation heads are `BasicBlock_0` and the 1x1 `Conv_0`; the separate
colorize and inpaint encoders are plain `ResNetFeatures_0` in every model
(the JAX package does not rematerialise them), their decoders the trunk
layout. The dense heads (`rot_head`, `pose_map_cls`, RotNet's `head`) go
from flax's (in, out) kernel to nn.Linear's (out, in) weight. The
standalone Autoencoder and RotNet are `encoder` (a plain
`ResNetFeatures_0` whatever the config's remat: the JAX modules do not
rematerialise), `decoder` and `head`. A `SegmentationNet` is `encoder` (a
depth encoder or an extractor, `ResNetFeatures_0`) and `decoder`: its 1x1
`Conv1x1_0`, then `ConvBlock_0..6` (per skip level its upconv and its
merge, then the last block) and the head `Conv3x3_0`.

The architecture options: each skip with variables is `depth_skips_i` or
`color_skips_i` (a skip without variables has no entry), holding its
attention (`CALayer_0`: `Conv_0`, `Conv_1`; or `AdaptivelyScaledCALayer_0`:
`SqueezeAndExcitationBlock_0` on the std, `_1` on the mean, the fusing
`Conv_0`, `SqueezeAndExcitationBlock_2`) and its 1x1 block (`Conv1x1_0`,
and the package's `BatchNorm_0/BatchNorm_0`). The pixel-shuffle CRP
decoder adds `UpShuffle_0..2/Conv_0` beside the unchanged `Conv3x3_*`
numbering (the shuffle's conv is a plain `nn.Conv`). HR-Depth's decoder is
`ConvBlock_0..17`, `Conv1x1_0..2` and `FSEModule_0..3` (`Dense_0`,
`Dense_1`, `Conv_0`) in creation order, and the heads `Conv3x3_0..3`;
DIFFNet's is `AttentionModule_0..3` (`ChannelAttention_0/Dense_0..1`,
`Conv_0`), `ConvBlock_0..1` and `Conv3x3_0..3`. The HRNet encoder sits
directly under `depth_encoder` (no wrapper, and no remat name whatever the
config's remat): its stem and transition convs and BatchNorms are
`Conv_k` / `BatchNorm_k` in creation order, layer1 `Bottleneck_0..3`, the
modules `_HRModule_0..7`, each `BasicBlock_0..` branch by branch and
`_FuseLayer_0` with its own `Conv_k` / `BatchNorm_k`. Its running
statistics are carried like every other BatchNorm's.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from tripled_tpu_torch.models.aux_nets import Autoencoder, Dense, RotNet
from tripled_tpu_torch.models.decoders import ColorDecoder, ImageDecoder
from tripled_tpu_torch.models.depth_decoder import DepthDecoder
from tripled_tpu_torch.models.encoders import DepthEncoder, Extractor, PoseEncoder
from tripled_tpu_torch.models.hr_decoders import DIFFDepthDecoder, HRDepthDecoder
from tripled_tpu_torch.models.hrnet import HRNetFeatures
from tripled_tpu_torch.models.layers import (
    AdaptivelyScaledCALayer,
    AttentionModule,
    CALayer,
    FSEModule,
)
from tripled_tpu_torch.models.net import DistillHead, SkipSplit, TripleDNet
from tripled_tpu_torch.models.pose_decoder import PoseDecoder
from tripled_tpu_torch.models.resnet import Bottleneck, ResNetFeatures
from tripled_tpu_torch.models.segmentation import SegDecoder, SegmentationNet


def _copy(tree):
    return {k: _copy(v) for k, v in tree.items()} if isinstance(tree, dict) else tree


class _Loader:
    def __init__(self, params: Dict[str, Any], stats: Dict[str, Any]):
        self.params = _copy(params)
        self.stats = _copy(stats or {})
        self.written: set[int] = set()

    def _pop(self, tree, path):
        node = tree
        for key in path[:-1]:
            if key not in node:
                raise KeyError(f"missing JAX variable {'/'.join(path)}")
            node = node[key]
        if path[-1] not in node:
            raise KeyError(f"missing JAX variable {'/'.join(path)}")
        return np.asarray(node.pop(path[-1]))

    def _write(self, tensor: torch.Tensor, value: np.ndarray, path):
        if tuple(tensor.shape) != value.shape:
            raise ValueError(f"{'/'.join(path)}: shape {value.shape} vs {tuple(tensor.shape)}")
        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(value)))
        self.written.add(id(tensor))

    def conv(self, conv: nn.Conv2d, path):
        kernel = self._pop(self.params, path + ("kernel",))
        self._write(conv.weight, kernel.transpose(3, 2, 0, 1), path + ("kernel",))
        if conv.bias is not None:
            self._write(conv.bias, self._pop(self.params, path + ("bias",)), path + ("bias",))

    def bn(self, bn: nn.BatchNorm2d, path):
        self._write(bn.weight, self._pop(self.params, path + ("scale",)), path + ("scale",))
        self._write(bn.bias, self._pop(self.params, path + ("bias",)), path + ("bias",))
        self._write(bn.running_mean, self._pop(self.stats, path + ("mean",)), path + ("mean",))
        self._write(bn.running_var, self._pop(self.stats, path + ("var",)), path + ("var",))

    def block(self, block, path):
        convs, bns = block.convs_and_bns()
        for j, (conv, bn) in enumerate(zip(convs, bns)):
            self.conv(conv, path + (f"Conv_{j}",))
            self.bn(bn, path + (f"BatchNorm_{j}",))

    def resnet(self, net: ResNetFeatures, path):
        self.conv(net.conv1, path + ("Conv_0",))
        self.bn(net.bn1, path + ("BatchNorm_0",))
        blocks = [b for stage in net.layers for b in stage]
        for i, block in enumerate(blocks):
            name = f"{'Bottleneck' if isinstance(block, Bottleneck) else 'BasicBlock'}_{i}"
            self.block(block, path + (name,))

    def depth_decoder(self, dec: DepthDecoder, path):
        for k, shuffle in enumerate(getattr(dec, "shuffles", ())):
            self.conv(shuffle.conv, path + (f"UpShuffle_{k}", "Conv_0"))
        for L, level in enumerate(dec.levels):
            self.conv(level.reduce, path + (f"Conv1x1_{L}", "Conv_0"))
            self.conv(level.iconv.conv, path + (f"Conv3x3_{3 * L}", "Conv_0"))
            for j, conv in enumerate(level.crp.convs):
                self.conv(conv, path + (f"CRPBlock_{L}", f"Conv1x1_{j}", "Conv_0"))
            self.conv(level.merge.conv, path + (f"Conv3x3_{3 * L + 1}", "Conv_0"))
            self.conv(level.disp.conv, path + (f"Conv3x3_{3 * L + 2}", "Conv_0"))

    def conv_block(self, block, index: int, path):
        self.conv(block.conv.conv, path + (f"ConvBlock_{index}", "Conv3x3_0", "Conv_0"))

    def trunk_decoder(self, dec, path):
        """ConvBlock_0.. in creation order: per level its upconv, its skip
        (ColorDecoder, where that level has one), its iconv; then the
        heads Conv3x3_0..3."""
        n = 0
        for level, (up, iconv) in enumerate(zip(dec.upconvs, dec.iconvs)):
            blocks = [up]
            if isinstance(dec, ColorDecoder) and level > 0 and dec.skip_layers[level - 1]:
                blocks.append(dec.skips[level - 1])
            for block in blocks + [iconv]:
                self.conv_block(block, n, path)
                n += 1
        self.heads(dec, path)

    def seg_decoder(self, dec: SegDecoder, path):
        self.conv(dec.reduce, path + ("Conv1x1_0", "Conv_0"))
        blocks = [b for pair in zip(dec.ups, dec.merges) for b in pair] + [dec.last]
        for j, block in enumerate(blocks):
            self.conv_block(block, j, path)
        self.conv(dec.head.conv, path + ("Conv3x3_0", "Conv_0"))

    def dense(self, m: nn.Linear, path):
        kernel = self._pop(self.params, path + ("kernel",))
        self._write(m.weight, kernel.T, path + ("kernel",))
        if m.bias is not None:
            self._write(m.bias, self._pop(self.params, path + ("bias",)), path + ("bias",))

    def ca_layer(self, att: CALayer, path):
        self.conv(att.conv1, path + ("Conv_0",))
        self.conv(att.conv2, path + ("Conv_1",))

    def asca(self, att: AdaptivelyScaledCALayer, path):
        for k, se in enumerate((att.se_std, att.se_mean, att.se_fused)):
            self.conv(se.conv1, path + (f"SqueezeAndExcitationBlock_{k}", "Conv_0"))
            self.conv(se.conv2, path + (f"SqueezeAndExcitationBlock_{k}", "Conv_1"))
        self.conv(att.fuse, path + ("Conv_0",))

    def skip(self, skip: SkipSplit, path):
        if isinstance(skip.attention, CALayer):
            self.ca_layer(skip.attention, path + ("CALayer_0",))
        elif isinstance(skip.attention, AdaptivelyScaledCALayer):
            self.asca(skip.attention, path + ("AdaptivelyScaledCALayer_0",))
        if hasattr(skip, "conv"):
            self.conv(skip.conv, path + ("Conv1x1_0", "Conv_0"))
            self.bn(skip.bn, path + ("BatchNorm_0", "BatchNorm_0"))

    def fse(self, fse: FSEModule, path):
        """The JAX FSEModule holds its gate's Dense layers itself."""
        self.attention_module(fse, path, gate=())

    def attention_module(self, att: AttentionModule, path, gate=("ChannelAttention_0",)):
        self.dense(att.attention.fc1, path + gate + ("Dense_0",))
        self.dense(att.attention.fc2, path + gate + ("Dense_1",))
        self.conv(att.conv, path + ("Conv_0",))

    def conv_bns(self, layers, path):
        for k, layer in enumerate(layers):
            self.conv(layer.conv, path + (f"Conv_{k}",))
            self.bn(layer.bn, path + (f"BatchNorm_{k}",))

    def hrnet(self, net: HRNetFeatures, path):
        self.conv_bns(net.conv_bns(), path)
        for b, block in enumerate(net.layer1):
            self.block(block, path + (f"Bottleneck_{b}",))
        modules = [m for stage in net.stages for m in stage]
        for k, module in enumerate(modules):
            p = path + (f"_HRModule_{k}",)
            blocks = [b for branch in module.branches for b in branch]
            for j, block in enumerate(blocks):
                self.block(block, p + (f"BasicBlock_{j}",))
            if module.fuse is not None:
                self.conv_bns([layer for chain in module.fuse.paths for layer in chain],
                              p + ("_FuseLayer_0",))

    def hr_depth_decoder(self, dec: HRDepthDecoder, path):
        for j, block in enumerate(dec.blocks):
            self.conv_block(block, j, path)
        for j, conv in enumerate(dec.reduces):
            self.conv(conv, path + (f"Conv1x1_{j}", "Conv_0"))
        for j, fse in enumerate(dec.fse):
            self.fse(fse, path + (f"FSEModule_{j}",))
        self.heads(dec, path)

    def diff_depth_decoder(self, dec: DIFFDepthDecoder, path):
        for j, att in enumerate(dec.attention):
            self.attention_module(att, path + (f"AttentionModule_{j}",))
        for j, block in enumerate(dec.blocks):
            self.conv_block(block, j, path)
        self.heads(dec, path)

    def heads(self, dec, path):
        for j, head in enumerate(dec.heads):
            self.conv(head.conv, path + (f"Conv3x3_{j}", "Conv_0"))

    def module(self, m: nn.Module, path=()):
        if isinstance(m, (TripleDNet, Autoencoder, RotNet, SegmentationNet)):
            for name, child in m.named_children():
                if isinstance(child, nn.ModuleList):  # flax names a list's items name_i
                    for i, item in enumerate(child):
                        self.module(item, path + (f"{name}_{i}",))
                else:
                    self.module(child, path + (name,))
        elif isinstance(m, SkipSplit):
            self.skip(m, path)
        elif isinstance(m, HRNetFeatures):
            self.hrnet(m, path)
        elif isinstance(m, HRDepthDecoder):
            self.hr_depth_decoder(m, path)
        elif isinstance(m, DIFFDepthDecoder):
            self.diff_depth_decoder(m, path)
        elif isinstance(m, (DepthEncoder, PoseEncoder, Extractor)):
            name = "ResNetFeatures_0"
            node = self.params
            for key in path:
                node = node.get(key, {})
            if "CheckpointResNetFeatures_0" in node:  # a remat=True model
                name = "CheckpointResNetFeatures_0"
            self.resnet(m.encoder, path + (name,))
        elif isinstance(m, ResNetFeatures):
            self.resnet(m, path)
        elif isinstance(m, DepthDecoder):
            self.depth_decoder(m, path)
        elif isinstance(m, (ImageDecoder, ColorDecoder)):
            self.trunk_decoder(m, path)
        elif isinstance(m, SegDecoder):
            self.seg_decoder(m, path)
        elif isinstance(m, Dense):
            self.dense(m, path)
        elif isinstance(m, DistillHead):
            self.block(m.block, path + ("BasicBlock_0",))
            self.conv(m.conv, path + ("Conv_0",))
        elif isinstance(m, PoseDecoder):
            for j, conv in enumerate(m.convs):
                self.conv(conv, path + (f"Conv_{j}",))
        else:
            raise TypeError(f"no JAX layout known for {type(m).__name__}")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,))


def load_jax_variables(model: nn.Module, params: Dict[str, Any],
                       batch_stats: Dict[str, Any] | None = None) -> None:
    """Write the JAX variables into `model` in place."""
    loader = _Loader(params, batch_stats or {})
    loader.module(model)
    left = list(_leaves(loader.params)) + list(_leaves(loader.stats))
    if left:
        raise ValueError(f"JAX variables left unused: {left[:8]}{' ...' if len(left) > 8 else ''}")
    unwritten = [name for name, t in list(model.named_parameters()) + list(model.named_buffers())
                 if id(t) not in loader.written and not name.endswith("num_batches_tracked")]
    if unwritten:
        raise ValueError(f"tensors not written from JAX variables: {unwritten[:8]}")
