"""Shared helper of the experiment configs (`configs/_common.py`). The data
root and ground-truth file come from $KITTI_PATH and $KITTI_GT_DEPTH."""

import os

from tripled_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, OptimConfig

KITTI_PATH = os.environ.get("KITTI_PATH", "/data/kitti_raw")
GT_DEPTH_PATH = os.environ.get("KITTI_GT_DEPTH", "/data/kitti_raw/gt_depths.npz")


def kitti_experiment(
    model_name: str,
    *,
    depth_layers=50,
    pose_layers=18,
    extractor_layers=50,
    frame_ids=(0, -1, 1),
    height=320,
    width=1024,
    batch_size=12,
    dataset="kitti",
    split="exp",
    total_epochs=40,
    lr_steps=(20, 30),
    erase_shape=(16, 16),
    erase_count=0,
    map_alphas=(),
    work_dir=None,
    **model_kw,
) -> ExperimentConfig:
    stereo = "s" in frame_ids
    model = ModelConfig(
        name=model_name,
        depth_num_layers=depth_layers,
        pose_num_layers=pose_layers,
        extractor_num_layers=extractor_layers,
        frame_ids=tuple(frame_ids),
        height=height,
        width=width,
        automask=not stereo,
        disp_norm=not stereo,
        **model_kw,
    )
    data = DataConfig(
        name=dataset,
        split=split,
        height=height,
        width=width,
        frame_ids=tuple(frame_ids),
        in_path=KITTI_PATH,
        gt_depth_path=GT_DEPTH_PATH,
        png=True,
        stereo_scale=stereo,
        erase_shape=tuple(erase_shape),
        erase_count=erase_count,
        map_alphas=tuple(map_alphas),
        batch_size=batch_size,
    )
    optim = OptimConfig(total_epochs=total_epochs, lr_steps=tuple(lr_steps))
    return ExperimentConfig(
        model=model,
        data=data,
        optim=optim,
        work_dir=work_dir or f"work/{model_name}",
    )
