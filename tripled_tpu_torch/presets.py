"""Model presets of the port, all 16 MONO names and the `Baseline` alias
(`tripled_tpu/models/registry.py:36-130`): `mono_baseline`, `mono_fm`,
`mono_fm_joint`, `mono_fm_joint_inpaint`,
`mono_fm_joint_inpaint_disentangle`, the five distillation presets, the
rotation pretext `mono_fm_joint_im_rot`, `mono_fm_joint_inpaint_map_pose`,
`mono_fm_joint_equivariant_inpaint`, and the standalone `autoencoder`,
`inpainter` and `rotnet`, which `build_model` returns as their own
modules (`models/aux_nets.py`). Two operating points: `mono_fm_bench()`
(`bench.py:118-140`) and `flagship_bench()` (`configs/cfg_kitti_tripled.py`),
both in float32 with the exact warp; and the two rows `bench.py` measures
at its defaults: `mono_fm_r50_192x640()` and `tripled_r50_320x1024()`,
in bf16 with bf16 texels and the 2x2 block warp."""

from __future__ import annotations

import dataclasses

from tripled_tpu_torch.config import DataConfig, ModelConfig, OptimConfig


def _mono_baseline(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(c, use_extractor=False, use_image_decoder=False,
                               perception_weight=0.0)


def _mono_fm(c: ModelConfig) -> ModelConfig:
    # FeatDepth: frozen extractor, perceptual loss only
    return dataclasses.replace(c, use_extractor=True, freeze_extractor=True,
                               joint_extractor=False, use_image_decoder=False)


def _mono_fm_joint(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(c, use_extractor=True, joint_extractor=True,
                               use_image_decoder=True)


def _mono_fm_joint_inpaint(c: ModelConfig) -> ModelConfig:
    c = _mono_fm_joint(c)
    use_ext = c.perception_weight != 0.0
    return dataclasses.replace(c, inpaint=True, use_extractor=use_ext,
                               use_image_decoder=use_ext and c.img_reconstruct_weight != 0)


def _sep(**flag):
    # the sep variants replace the disentangle ColorDecoder branch with their
    # own encoder-decoder pair, and have no auto_res term, whatever the
    # config's auto_res_weight
    def preset(c: ModelConfig) -> ModelConfig:
        return dataclasses.replace(_mono_fm_joint_inpaint(c), auto_res_weight=0.0, **flag)
    return preset


def _map_pose(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(_mono_fm_joint_inpaint(c), map_pose=True)


def _equivariant(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(_mono_fm_joint_inpaint(c), equivariant=True, use_extractor=True,
                               use_image_decoder=True)


def _im_rot(c: ModelConfig) -> ModelConfig:
    return dataclasses.replace(_mono_fm_joint(c), im_rot=True, use_image_decoder=False)


def _standalone(c: ModelConfig) -> ModelConfig:
    return c


PRESETS = {
    "mono_baseline": _mono_baseline,
    "Baseline": _mono_baseline,
    "mono_fm": _mono_fm,
    "mono_fm_joint": _mono_fm_joint,
    "mono_fm_joint_inpaint": _mono_fm_joint_inpaint,
    "mono_fm_joint_inpaint_disentangle": _mono_fm_joint_inpaint,
    # with perception_weight=0 (their configs) these two have no extractor
    "mono_fm_joint_inpaint_distill_gs": _mono_fm_joint_inpaint,
    "mono_fm_joint_inpaint_distill_colorize": _mono_fm_joint_inpaint,
    "mono_fm_joint_inpaint_disentangle_distill_colorize": _mono_fm_joint_inpaint,
    "mono_fm_joint_inpaint_disentangle_distill_sep_colorize": _sep(sep_colorize=True),
    "mono_fm_joint_inpaint_disentangle_distill_sep_inpaint": _sep(sep_inpaint=True),
    "mono_fm_joint_inpaint_map_pose": _map_pose,
    "mono_fm_joint_equivariant_inpaint": _equivariant,
    "mono_fm_joint_im_rot": _im_rot,
    "autoencoder": _standalone,
    "inpainter": _standalone,
    "rotnet": _standalone,
}

# the pretext presets, whose steps are ported in float32 only
PRETEXT_PRESETS = ("mono_fm_joint_im_rot", "autoencoder", "inpainter", "rotnet",
                   "mono_fm_joint_inpaint_map_pose", "mono_fm_joint_equivariant_inpaint")


def canonicalize(cfg: ModelConfig) -> ModelConfig:
    """Apply the preset named by `cfg.name`."""
    if cfg.name not in PRESETS:
        raise KeyError(f"unknown model {cfg.name!r}; available: {sorted(PRESETS)}")
    return PRESETS[cfg.name](cfg)


def build_model(cfg: ModelConfig):
    """The module of the preset `cfg.name` (`registry.py:146-158`):
    `Autoencoder` for autoencoder, the masked one for inpainter, `RotNet`
    for rotnet, `TripleDNet` for every other name."""
    from tripled_tpu_torch.models.aux_nets import Autoencoder, RotNet
    from tripled_tpu_torch.models.net import TripleDNet

    cfg = canonicalize(cfg)
    if cfg.name == "autoencoder":
        return Autoencoder(cfg)
    if cfg.name == "inpainter":
        return Autoencoder(cfg, masked=True)
    if cfg.name == "rotnet":
        return RotNet(cfg)
    return TripleDNet(cfg)


def mono_fm_bench() -> tuple[ModelConfig, DataConfig, OptimConfig]:
    """FeatDepth at the benchmark's operating point: R50 depth, R18 pose,
    frozen R50 extractor, 192x640, batch 12."""
    model = canonicalize(
        ModelConfig(
            name="mono_fm",
            depth_num_layers=50,
            pose_num_layers=18,
            extractor_num_layers=50,
            height=192,
            width=640,
            perception_weight=1e-3,
        )
    )
    data = DataConfig(batch_size=12)
    return model, data, OptimConfig(warmup_iters=2)


def flagship_bench() -> tuple[ModelConfig, DataConfig, OptimConfig]:
    """TripleDNet, the paper's model: the values of
    `configs/cfg_kitti_tripled.py` through `configs/_common.py`. R50 depth,
    R18 pose at its fixed 192x640, joint R50 extractor, 320x1024, batch 12,
    the last encoder stage split between depth and colour, 16 erased 16x16
    squares per sample, float32, with the config's `remat=True`: remat
    changes no number (`tests/test_torch_port_remat.py`), only memory and
    time. For the mixed-precision step, replace `compute_dtype` with
    "bfloat16"."""
    model = canonicalize(
        ModelConfig(
            name="mono_fm_joint_inpaint_disentangle",
            depth_num_layers=50,
            pose_num_layers=18,
            extractor_num_layers=50,
            height=320,
            width=1024,
            automask=True,
            disp_norm=True,
            dis=1e-3,
            cvt=1e-3,
            perception_weight=1e-3,
            smoothness_weight=1e-3,
            auto_res_weight=5e-3,
            disentangle_layers=(False, False, False, False, True),
            skip_connection_multiplier=1.0,
            depth_disentangle_type="use_half",
            remat=True,
        )
    )
    data = DataConfig(batch_size=12, erase_shape=(16, 16), erase_count=16)
    return model, data, OptimConfig(lr_steps=(10, 20))


def mono_fm_r50_192x640() -> tuple[ModelConfig, DataConfig, OptimConfig]:
    """`bench.py`'s headline row, `train_imgs_per_sec_mono_fm_r50_192x640`:
    `mono_fm_cfg()` at its environment defaults (`bench.py:118-147`,
    BENCH_BF16, BENCH_BF16_WARP and BENCH_BLOCK_WARP on, the block shape
    2,2, the fused photometric path, no remat, no eq-mask pool) at
    BENCH_BATCH's 16 (`bench.py:478`): `mono_fm_bench()` in bf16 with bf16
    texels and the 2x2 block warp."""
    model, data, optim = mono_fm_bench()
    model = dataclasses.replace(model, compute_dtype="bfloat16", warp_gather_dtype="bfloat16",
                                warp_block_gather=True, warp_block_shape=(2, 2))
    return model, dataclasses.replace(data, batch_size=16), optim


def tripled_r50_320x1024() -> tuple[ModelConfig, DataConfig, OptimConfig]:
    """`bench.py`'s flagship row, `train_imgs_per_sec_tripleD_r50_320x1024`:
    `flagship_cfg()` at its environment defaults (`bench.py:150-179`: bf16
    with remat, bf16 texels and the 2x2 block warp, the fused photometric
    path) at BENCH_FLAGSHIP_BATCH's bf16 default of 8 (`bench.py:552`):
    `flagship_bench()` so changed. The byte cap that `flagship_cfg()`
    raises matters only to a block other than 2x2."""
    model, data, optim = flagship_bench()
    model = dataclasses.replace(model, compute_dtype="bfloat16", remat=True,
                                warp_gather_dtype="bfloat16", warp_block_gather=True,
                                warp_block_shape=(2, 2))
    return model, dataclasses.replace(data, batch_size=8), optim
