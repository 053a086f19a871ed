"""6-DoF pose decoder (`tripled_tpu/models/pose_decoder.py`): 1x1 reduce,
two 3x3 convs, 1x1 to 6 channels, spatial mean, x0.01."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class PoseDecoder(nn.Module):
    def __init__(self, in_channels: int = 512):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv2d(in_channels, 256, 1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 256, 3, padding=1),
            nn.Conv2d(256, 6, 1),
        ])

    def forward(self, bottom):
        """(B, C, h, w) -> (axisangle (B, 1, 1, 3), translation (B, 1, 1, 3))."""
        x = bottom
        for conv in self.convs[:3]:
            x = F.relu(conv(x))
        x = self.convs[3](x).mean(dim=(2, 3)) * 0.01
        out = x.reshape(-1, 1, 1, 6)
        return out[..., :3], out[..., 3:]
