"""Frozen configuration dataclasses (`tripled_tpu/config.py`): every field
of the JAX package's `ModelConfig`, `DataConfig`, `OptimConfig` and
`ExperimentConfig`, in the same order and with the same defaults: the
fields of all 16 MONO presets (the map-pose, equivariant and
rotation-pretext fields included), every architecture option (the
attention and 1x1 disentangle skips, the 1x1 colour skips, `use_pfp`, the
pixel-shuffle depth decoder, HR-Depth and DIFFNet), the warp and kernel
options (the block warp, the gather dtype, the warp's align-corners
convention, the photometric path, the eq-mask pool) and the stereo frame
"s" in `frame_ids`. The pretext presets (`presets.PRETEXT_PRESETS`) and
the architecture options take only float32. Experiment configs are python
files defining `config` (`tripled_tpu_torch/configs/`), read with
`load_config`."""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import pprint
import sys


_ARCHITECTURE_OPTIONS = ("depth_skip_type", "depth_disentangle_type", "color_skip_type",
                         "use_pfp", "use_hr_depth", "use_diffnet", "depth_use_shuffle")


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
    # each depth skip: channel ("ca"), pixel ("pa") or adaptively scaled
    # ("asca") attention, or "1x1": an undivided last stage gets a 1x1
    # conv, BatchNorm and ELU
    depth_skip_type: str | None = None
    # how a disentangled stage gives the depth decoder half its channels:
    # the left half ("use_half") or a 1x1 conv, BatchNorm and ELU ("1x1")
    depth_disentangle_type: str = "use_half"
    # "1x1": the colour decoder sees whole stages, those of
    # color_skip_layers through a 1x1 conv to half their channels
    color_skip_type: str | None = None
    color_skip_layers: tuple = (False, False, False, False)
    skip_connection_multiplier: float = 1.0
    auto_res_weight: float = 0.0
    # pose from prediction: the pose net sees the colour decoder's
    # reconstruction of the target in place of the target frame
    use_pfp: bool = False

    # distillation heads: depth to grayscale (d2g) and depth + L to ab
    d2g_weight: float = 0.0
    colorize_weight: float = 0.0
    use_normal: bool = False          # the heads also see the surface normal
    use_lab: bool = False             # the grayscale target is Lab L, not Rec.601
    use_mask: bool = False            # the heads see the erased input, scored on the erased pixels
    use_distill_mask: bool = False    # the sep losses are scored on the erased pixels

    # separate-encoder distill variants
    sep_colorize: bool = False
    sep_inpaint: bool = False
    cond_encoder: bool = False        # the depth embedding conditions the sep encoder
    inpaint_weight: float = 0.0
    colorize_num_layers: int = 50
    inpaint_num_layers: int = 50

    # map-pose pretext: the pose net also classifies which of the
    # map_output alpha pairs mixed the motion-masked frames
    map_pose: bool = False
    map_output: int = 0
    map_pose_weight: float = 0.0

    # equivariant pretext: the extractor's source features, warped into the
    # target, decode the source frame outside the warped erase mask
    equivariant: bool = False
    equivariant_weight: float = 0.0

    # rotation pretext (rotnet, mono_fm_joint_im_rot): a batch-shared
    # pretext_resize crop, each sample rotated by k * 90 degrees, and a
    # pretext_label_size-way head on the extractor
    im_rot: bool = False
    pretext_resize: int = 224
    pretext_label_size: int = 4
    pretext_weight: float = 1.0

    # depth networks: HR-Depth's nested decoder; DIFFNet, an HRNet encoder
    # of width depth_num_layers on the raw image with its attention
    # decoder; the CRP decoder upsampling by pixel shuffle
    use_hr_depth: bool = False
    use_diffnet: bool = False
    depth_use_shuffle: bool = False
    # dropout on the two deepest skips of the CRP DepthDecoder; 0.0 for
    # deterministic parity runs
    depth_dropout_rate: float = 0.5

    # the warp's sampling convention. True samples at the pixel
    # coordinates themselves; False at x * W/(W-1) - 0.5 (and the same in
    # y), what the reference's (W-1, H-1) normalisation gives under
    # F.grid_sample's default align_corners=False (`models/net.py`
    # `_grid_sample`)
    warp_align_corners: bool = True
    # "bfloat16": mixed precision. The networks fed bf16 inputs compute in
    # bf16 on bf16-rounded parameters; warps, geometry, the losses'
    # reductions, BatchNorm statistics, master parameters and Adam's moments
    # stay float32 (`models/net.py` `_cd`/`_f32`, `train/step.py`)
    compute_dtype: str = "float32"
    # "bfloat16": the warp's texels are rounded to bf16 before the
    # interpolation, which stays in the wider dtype (`ops/warp.py`)
    warp_gather_dtype: str = "float32"
    # the block warp: each warp_block_shape block of output pixels samples
    # inside one (bh+2) x (bw+2) source patch, a sample beyond it clamped
    # to its edge (`ops/warp.grid_sample_block`). Equal to the exact warp
    # except where a block's samples spread wider (depth
    # discontinuities); opt-in
    warp_block_gather: bool = False
    # (bh, bw) of the block warp on the colour warp (at most 4 channels)
    warp_block_shape: tuple = (2, 2)
    # the block warp also on the 64-channel half-resolution feature warp,
    # always in (2, 2) blocks
    warp_block_features: bool = False
    # the fused photometric path (the name is the JAX package's, whose
    # kernel is Pallas): the CUDA kernels `ops/photometric.py` on a CUDA
    # tensor and their plain version on the CPU, an exact tie going to the
    # identity candidates. False: the unfused path, each candidate's
    # reprojection loss and `ops/losses.min_reprojection_with_automask`,
    # with the 1e-5 tie-break noise on the identity losses in training
    use_pallas_photometric: bool = True
    # the CRP decoder's 5x5 max pools route an exact tie's gradient to
    # every tied position, divided among them, instead of to one
    # (`models/layers.max_pool_5x5_same_eqmask`); opt-in
    pool_eqmask_grad: bool = False
    # recompute the encoders' and the depth, image and colour decoders'
    # activations in the backward instead of keeping them (less memory, more
    # arithmetic, the same numbers)
    remat: bool = False

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be 'float32' or 'bfloat16', "
                             f"got {self.compute_dtype!r}")
        # a list becomes a tuple; the JAX package's check and message
        bs = tuple(self.warp_block_shape)
        if len(bs) != 2 or not all(isinstance(v, int) and v >= 1 for v in bs):
            raise ValueError(f"warp_block_shape must be two positive ints, got "
                             f"{self.warp_block_shape!r}")
        object.__setattr__(self, "warp_block_shape", bs)
        if self.compute_dtype == "bfloat16":
            later = "a later slice of the port"
            # imported here, and only for bf16: presets imports this module,
            # whose ExperimentConfig builds a default ModelConfig at import
            from tripled_tpu_torch.presets import PRETEXT_PRESETS
            if self.name in PRETEXT_PRESETS:
                raise ValueError(f"compute_dtype='bfloat16' for {self.name!r} waits for {later}")
            if self.architecture_options():
                raise ValueError(f"compute_dtype='bfloat16' with {self.architecture_options()} "
                                 f"waits for {later}")

    def architecture_options(self) -> list[str]:
        """The architecture options this config sets off their defaults."""
        return [f.name for f in dataclasses.fields(self)
                if f.name in _ARCHITECTURE_OPTIONS and getattr(self, f.name) != f.default]

    @property
    def num_frames(self) -> int:
        return len(self.frame_ids)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "kitti"
    split: str = "exp"
    height: int = 192
    width: int = 640
    frame_ids: tuple = (0, -1, 1)
    in_path: str = ""
    gt_depth_path: str = ""
    png: bool = True
    stereo_scale: bool = False
    # inpaint erase masks: erase_count squares of erase_shape per sample
    erase_shape: tuple = (16, 16)
    erase_count: int = 0
    # map-pose alphas
    map_alphas: tuple = ()
    # also emit the Lab conversion of each resized frame
    add_lab: bool = False
    # loader
    batch_size: int = 12
    shuffle: bool = True
    seed: int = 1024
    # in-RAM cache of decoded and resized frames (uint8, lossless), in MB;
    # 0 = off. Env override: TRIPLED_DECODE_CACHE_MB.
    decode_cache_mb: int = 0
    # training samples carry 9 jitter floats, and the model makes color_aug
    # on the device (`ops/jitter.py`); frames cross to the device as uint8
    # and are divided by 255 there (training needs device_color_aug)
    device_color_aug: bool = False
    ship_uint8: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    grad_clip_norm: float = 35.0
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    lr_steps: tuple = (20, 30)   # epochs
    lr_gamma: float = 0.5
    total_epochs: int = 40
    # paramwise multipliers: non-norm biases (lr / weight decay) and
    # norm-layer weight decay
    bias_lr_mult: float = 1.0
    bias_decay_mult: float = 1.0
    norm_decay_mult: float = 1.0


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    optim: OptimConfig = OptimConfig()
    work_dir: str = "work_dir"
    seed: int = 1024
    validate: bool = True
    validate_interval: int = 1
    checkpoint_interval: int = 1
    log_interval: int = 50
    resume_from: str | None = None
    finetune: str | None = None
    load_from: str | None = None


def load_config(path: str) -> ExperimentConfig:
    """Execute a python config file that defines `config`, an
    ExperimentConfig of this package. The file's directory is on sys.path
    while it runs, so that it may import a sibling helper; the port's own
    configs import theirs by package path, since a bare `_common` may
    already stand in sys.modules for another package's configs."""
    cfg_dir = os.path.dirname(os.path.abspath(path))
    spec = importlib.util.spec_from_file_location("_experiment_config", path)
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, cfg_dir)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path.remove(cfg_dir)
    cfg = getattr(mod, "config", None)
    if not isinstance(cfg, ExperimentConfig):
        raise TypeError(f"{path} must define `config`, a {__name__}.ExperimentConfig; "
                        f"got {type(cfg).__module__}.{type(cfg).__qualname__}")
    return cfg


def dump_config(cfg: ExperimentConfig, path: str) -> None:
    with open(path, "w") as f:
        f.write(pprint.pformat(dataclasses.asdict(cfg), width=100))
