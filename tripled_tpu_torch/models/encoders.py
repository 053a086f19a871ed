"""Depth, pose and extractor encoders (`tripled_tpu/models/encoders.py`).

They take NCHW images in [0, 1]. The depth and pose encoders normalise as
(x - 0.45) / 0.225 in the input's dtype, each constant rounded to that
dtype and each operation rounded, as XLA computes the JAX package's weakly
typed constants (a bf16 image meets bf16(0.45) and bf16(0.225)); the
extractor takes its input as it is. With `remat`, each recomputes its ResNet's activations in the
backward, as `tripled_tpu/models/encoders.py:23-29` wraps it in nn.remat."""

from __future__ import annotations

import torch.nn as nn

from tripled_tpu_torch.models.resnet import ResNetFeatures, stage_channels


def _norm(x):
    # 0-d tensors, not Python numbers: a Python number meets a bf16 tensor
    # in float32, and CUDA turns a divide by one into a multiply
    return (x - x.new_tensor(0.45)) / x.new_tensor(0.225)


class DepthEncoder(nn.Module):
    def __init__(self, num_layers: int = 18, remat: bool = False):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers, remat=remat)

    def forward(self, x):
        return self.encoder(_norm(x))


class PoseEncoder(nn.Module):
    """ResNet over `num_input_images` channel-concatenated frames."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 2, remat: bool = False):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers, in_channels=3 * num_input_images, remat=remat)

    def forward(self, x):
        return self.encoder(_norm(x))


class Extractor(nn.Module):
    """The feature-metric extractor, and the separate colorize and inpaint
    encoders; unnormalised input, optional additive per-stage conditioning
    features (`ResNetFeatures`)."""

    def __init__(self, num_layers: int = 50, remat: bool = False):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers, remat=remat)

    def forward(self, x, graph_stages: int = 5, cond_features=None):
        return self.encoder(x, graph_stages, cond_features)
