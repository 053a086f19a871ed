"""Training state (`tripled_tpu/train/state.py`): the model, holding
parameters and BatchNorm statistics, and its optimizer. The model is the
preset's module: `TripleDNet`, or for autoencoder, inpainter and rotnet
their own (`presets.build_model`), or a `SegmentationNet`
(`create_segmentation_state`)."""

from __future__ import annotations

import dataclasses

import torch

from tripled_tpu_torch.config import ModelConfig, OptimConfig
from tripled_tpu_torch.models.segmentation import build_segmentation_model
from tripled_tpu_torch.presets import build_model
from tripled_tpu_torch.train.optim import Adam


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Adam


def create_train_state(model_cfg: ModelConfig, optim_cfg: OptimConfig, steps_per_epoch: int,
                       seed: int = 0, device: str = "cuda") -> TrainState:
    """Random initial weights from `seed` (drawn on the CPU, so that they do
    not depend on the device), then moved to `device`."""
    return _state(lambda: build_model(model_cfg), optim_cfg, steps_per_epoch, seed, device)


def create_segmentation_state(model_cfg: ModelConfig, optim_cfg: OptimConfig,
                              steps_per_epoch: int, name: str = "FixSegmentationDepth",
                              num_classes: int = 20, seed: int = 0,
                              device: str = "cuda") -> TrainState:
    """The segmentation model `name` over `model_cfg`'s encoders, drawn as
    `create_train_state` draws a preset's."""
    return _state(lambda: build_segmentation_model(model_cfg, name, num_classes), optim_cfg,
                  steps_per_epoch, seed, device)


def _state(build, optim_cfg, steps_per_epoch, seed, device) -> TrainState:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build()
    model.to(device)
    return TrainState(model, Adam(model, optim_cfg, steps_per_epoch))
