"""Training state (`tripled_tpu/train/state.py`): the model, holding
parameters and BatchNorm statistics, and its optimizer."""

from __future__ import annotations

import dataclasses

import torch

from tripled_tpu_torch.config import ModelConfig, OptimConfig
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.train.optim import Adam


@dataclasses.dataclass
class TrainState:
    model: TripleDNet
    optimizer: Adam


def create_train_state(model_cfg: ModelConfig, optim_cfg: OptimConfig, steps_per_epoch: int,
                       seed: int = 0, device: str = "cuda") -> TrainState:
    """Random initial weights from `seed` (drawn on the CPU, so that they do
    not depend on the device), then moved to `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TripleDNet(model_cfg)
    model.to(device)
    return TrainState(model, Adam(model, optim_cfg, steps_per_epoch))
