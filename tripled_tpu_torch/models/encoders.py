"""Depth, pose and extractor encoders (`tripled_tpu/models/encoders.py`).

They take NCHW images in [0, 1]. The depth and pose encoders normalise as
(x - 0.45) / 0.225; the extractor takes its input as it is."""

from __future__ import annotations

import torch.nn as nn

from tripled_tpu_torch.models.resnet import ResNetFeatures, stage_channels


def _norm(x):
    return (x - 0.45) / 0.225


class DepthEncoder(nn.Module):
    def __init__(self, num_layers: int = 18):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers)

    def forward(self, x):
        return self.encoder(_norm(x))


class PoseEncoder(nn.Module):
    """ResNet over `num_input_images` channel-concatenated frames."""

    def __init__(self, num_layers: int = 18, num_input_images: int = 2):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers, in_channels=3 * num_input_images)

    def forward(self, x):
        return self.encoder(_norm(x))


class Extractor(nn.Module):
    """The feature-metric extractor; unnormalised [0, 1] input."""

    def __init__(self, num_layers: int = 50):
        super().__init__()
        self.num_ch_enc = stage_channels(num_layers)
        self.encoder = ResNetFeatures(num_layers)

    def forward(self, x):
        return self.encoder(x)
