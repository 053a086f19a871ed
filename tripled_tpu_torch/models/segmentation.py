"""Segmentation models over depth-pretrained encoders
(`tripled_tpu/models/segmentation.py`), NCHW inside, NHWC in and out:

- `SegmentationNet(encoder_source='depth')`, BaseSegmentationDepth: the
  depth ResNet encoder, a light refine decoder and a per-pixel log-softmax
  over `num_classes`;
- `encoder_source='feat'`, BaseSegmentationFeat: the extractor encoder;
- `freeze_encoder=True`, FixSegmentationDepth: no gradient reaches the
  encoder (the JAX package's `stop_gradient`); its BatchNorm layers still
  run in train mode, so their running statistics move.

As in the JAX package, the encoder computes in float32 without remat
whatever the config says, and the depth encoder normalises its input by
(x - 0.45) / 0.225 on top of the datasets' ImageNet normalisation. In
train mode the forward returns ({'log_probs'}, {'seg_ce_loss'}), the mean
cross-entropy over the pixels whose label is not void; in eval mode the
log-probabilities, upsampled to the input's size.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.data.cityscapes_labels import VOID_TRAIN_ID
from tripled_tpu_torch.models.encoders import DepthEncoder, Extractor
from tripled_tpu_torch.models.layers import Conv1x1, Conv3x3, ConvBlock
from tripled_tpu_torch.ops.image import resize_bilinear, upsample2x_nearest


class SegDecoder(nn.Module):
    """From the encoder's deepest stage up to stride 2 over the skips of
    stages 3, 2 and 1 (stage 0 is not read): logits at half the input's
    size."""

    def __init__(self, num_ch_enc, num_classes: int = 20):
        super().__init__()
        self.reduce = Conv1x1(num_ch_enc[4], 256)
        self.ups, self.merges = nn.ModuleList(), nn.ModuleList()
        ch = 256
        for skip in (num_ch_enc[3], num_ch_enc[2], num_ch_enc[1]):
            self.ups.append(ConvBlock(ch, skip))
            ch = min(2 * skip, 256)
            self.merges.append(ConvBlock(2 * skip, ch))
        self.last = ConvBlock(ch, 64)
        self.head = Conv3x3(64, num_classes)

    def forward(self, features):
        x = self.reduce(features[4])
        for up, merge, skip in zip(self.ups, self.merges, (features[3], features[2], features[1])):
            x = torch.cat([upsample2x_nearest(up(x)), skip], dim=1)
            x = merge(x)
        return self.head(self.last(upsample2x_nearest(x)))


class SegmentationNet(nn.Module):
    def __init__(self, cfg: ModelConfig, num_classes: int = 20, encoder_source: str = "depth",
                 freeze_encoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.encoder_source = encoder_source
        self.freeze_encoder = freeze_encoder
        if encoder_source == "feat":
            self.encoder = Extractor(cfg.extractor_num_layers)
        else:
            self.encoder = DepthEncoder(cfg.depth_num_layers)
        self.decoder = SegDecoder(self.encoder.num_ch_enc, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor]):
        image = batch["image"]
        with torch.no_grad() if self.freeze_encoder else nullcontext():
            feats = self.encoder(image.permute(0, 3, 1, 2))
        logits = self.decoder(feats).permute(0, 2, 3, 1)
        logits = resize_bilinear(logits, image.shape[1], image.shape[2])
        log_probs = F.log_softmax(logits, dim=-1)
        if not self.training:
            return log_probs
        labels = batch["label"].long()
        valid = (labels != VOID_TRAIN_ID).to(log_probs.dtype)
        ll = log_probs.gather(-1, labels[..., None])[..., 0]
        ce = -(ll * valid).sum() / valid.sum().clamp_min(1)
        return {"log_probs": log_probs}, {"seg_ce_loss": ce}


SEGMENTATION = {
    "BaseSegmentationDepth": dict(encoder_source="depth", freeze_encoder=False),
    "BaseSegmentationFeat": dict(encoder_source="feat", freeze_encoder=False),
    "FixSegmentationDepth": dict(encoder_source="depth", freeze_encoder=True),
}


def build_segmentation_model(cfg: ModelConfig, name: str = "FixSegmentationDepth",
                             num_classes: int = 20) -> SegmentationNet:
    if name not in SEGMENTATION:
        raise KeyError(f"unknown segmentation model '{name}': {sorted(SEGMENTATION)}")
    return SegmentationNet(cfg, num_classes=num_classes, **SEGMENTATION[name])
