"""Frozen configuration dataclasses: the fields of the JAX package's
`ModelConfig`, `DataConfig` and `OptimConfig` (`tripled_tpu/config.py`)
that the mono_baseline, mono_fm and mono_fm_joint* training steps read,
with the same defaults. A field whose other values belong to branches not
ported yet (attention or 1x1 skips, `use_pfp`) takes only its default."""

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
    dis: float = 1e-3    # feature regularisation: first-order (maximised) weight
    cvt: float = 1e-3    # feature regularisation: second-order (minimised) weight
    img_reconstruct_weight: float = 1.0

    use_extractor: bool = False    # perceptual (feature-metric) branch exists
    joint_extractor: bool = False  # the extractor trains (feature regularisation)
    freeze_extractor: bool = False  # no gradient through the extractor
    use_image_decoder: bool = False  # ImageDecoder reconstructs the target
    inpaint: bool = False            # the reconstruction is scored on erased pixels

    # disentangle (TripleD): per encoder stage, whether its channels are
    # split between the depth branch (left half) and the colour branch
    disentangle_layers: tuple = (False, False, False, False, False)
    depth_skip_type: str | None = None         # only None is ported
    depth_disentangle_type: str = "use_half"   # only "use_half" is ported
    color_skip_type: str | None = None         # only None is ported
    color_skip_layers: tuple = (False, False, False, False)
    skip_connection_multiplier: float = 1.0
    auto_res_weight: float = 0.0
    use_pfp: bool = False                      # only False is ported

    # dropout on the two deepest skips of the CRP DepthDecoder; 0.0 for
    # deterministic parity runs
    depth_dropout_rate: float = 0.5

    def __post_init__(self):
        later = "a later slice of the port"
        if self.depth_skip_type is not None:
            raise ValueError(f"depth_skip_type={self.depth_skip_type!r} waits for {later}")
        if self.color_skip_type is not None:
            raise ValueError(f"color_skip_type={self.color_skip_type!r} waits for {later}")
        if self.use_pfp:
            raise ValueError(f"use_pfp=True waits for {later}")
        if self.depth_disentangle_type != "use_half":
            raise ValueError(f"depth_disentangle_type={self.depth_disentangle_type!r} "
                             f"waits for {later}")

    @property
    def num_frames(self) -> int:
        return len(self.frame_ids)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 12
    # inpaint erase masks: erase_count squares of erase_shape per sample
    erase_shape: tuple = (16, 16)
    erase_count: int = 0


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
