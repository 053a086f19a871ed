"""Load the JAX package's variables into the port's modules.

`params` and `batch_stats` are the JAX package's trees as nested dicts of
numpy arrays. Conv kernels go from HWIO to OIHW; flax BatchNorm
`scale`/`bias`/`mean`/`var` go to `weight`/`bias`/`running_mean`/
`running_var`. Every key is consumed and every tensor of the module is
written: a missing key, a leftover key or an unwritten tensor raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from tripled_tpu_torch.models.depth_decoder import DepthDecoder
from tripled_tpu_torch.models.encoders import DepthEncoder, Extractor, PoseEncoder
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.models.pose_decoder import PoseDecoder
from tripled_tpu_torch.models.resnet import Bottleneck, ResNetFeatures


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

    def resnet(self, net: ResNetFeatures, path):
        self.conv(net.conv1, path + ("Conv_0",))
        self.bn(net.bn1, path + ("BatchNorm_0",))
        blocks = [b for stage in net.layers for b in stage]
        for i, block in enumerate(blocks):
            name = f"{'Bottleneck' if isinstance(block, Bottleneck) else 'BasicBlock'}_{i}"
            convs, bns = block.convs_and_bns()
            for j, (conv, bn) in enumerate(zip(convs, bns)):
                self.conv(conv, path + (name, f"Conv_{j}"))
                self.bn(bn, path + (name, f"BatchNorm_{j}"))

    def depth_decoder(self, dec: DepthDecoder, path):
        for L, level in enumerate(dec.levels):
            self.conv(level.reduce, path + (f"Conv1x1_{L}", "Conv_0"))
            self.conv(level.iconv.conv, path + (f"Conv3x3_{3 * L}", "Conv_0"))
            for j, conv in enumerate(level.crp.convs):
                self.conv(conv, path + (f"CRPBlock_{L}", f"Conv1x1_{j}", "Conv_0"))
            self.conv(level.merge.conv, path + (f"Conv3x3_{3 * L + 1}", "Conv_0"))
            self.conv(level.disp.conv, path + (f"Conv3x3_{3 * L + 2}", "Conv_0"))

    def module(self, m: nn.Module, path=()):
        if isinstance(m, TripleDNet):
            for name, child in m.named_children():
                self.module(child, path + (name,))
        elif isinstance(m, (DepthEncoder, PoseEncoder, Extractor)):
            self.resnet(m.encoder, path + ("ResNetFeatures_0",))
        elif isinstance(m, ResNetFeatures):
            self.resnet(m, path)
        elif isinstance(m, DepthDecoder):
            self.depth_decoder(m, path)
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
