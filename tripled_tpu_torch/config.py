"""Frozen configuration dataclasses: the fields of the JAX package's
`ModelConfig`, `DataConfig` and `OptimConfig` (`tripled_tpu/config.py`)
that the mono_fm / mono_baseline training step reads, with the same
defaults."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "mono_baseline"
    depth_num_layers: int = 18
    pose_num_layers: int = 18
    extractor_num_layers: int = 50
    frame_ids: tuple = (0, -1, 1)
    height: int = 192
    width: int = 640
    scales: tuple = (0, 1, 2, 3)
    min_depth: float = 0.1
    max_depth: float = 100.0
    # the pose net always runs at this fixed resolution
    pose_height: int = 192
    pose_width: int = 640

    automask: bool = True
    disp_norm: bool = True
    smoothness_weight: float = 1e-3
    perception_weight: float = 1e-3

    use_extractor: bool = False    # perceptual (feature-metric) branch exists
    freeze_extractor: bool = False  # no gradient through the extractor

    # dropout on the two deepest skips of the CRP DepthDecoder; 0.0 for
    # deterministic parity runs
    depth_dropout_rate: float = 0.5

    @property
    def num_frames(self) -> int:
        return len(self.frame_ids)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 12


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_steps: tuple = (20, 30)   # epochs
    lr_gamma: float = 0.5
    # paramwise multipliers: non-norm biases (lr / weight decay) and
    # norm-layer weight decay
    bias_lr_mult: float = 1.0
    bias_decay_mult: float = 1.0
    norm_decay_mult: float = 1.0
