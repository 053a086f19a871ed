"""Dataset factory (`tripled_tpu/data/get_dataset.py`)."""

from __future__ import annotations

from tripled_tpu_torch.config import DataConfig
from tripled_tpu_torch.data.datasets import (
    ETH3DDataset,
    EuRoCDataset,
    FolderDataset,
    KITTIDepthDataset,
    KITTIInpaintDataset,
    KITTIMapDataset,
    KITTIOdomDataset,
    KITTIRawDataset,
)
from tripled_tpu_torch.data.readers import readlines, split_file_path

_DATASETS = {
    "kitti": KITTIRawDataset,
    "kitti_inpaint": KITTIInpaintDataset,
    "kitti_map": KITTIMapDataset,
    "kitti_odom": KITTIOdomDataset,
    "kitti_depth": KITTIDepthDataset,
    "folder": FolderDataset,
    "eth3d": ETH3DDataset,
    "euroc": EuRoCDataset,
}
# names the JAX package knows whose datasets wait for a later slice
# (CityscapeDataset needs the optional lmdb package)
_LATER = ("cityscape",)


def get_dataset(cfg: DataConfig, training: bool = True, split_file: str | None = None):
    cls = _DATASETS.get(cfg.name)
    if cls is None:
        if cfg.name in _LATER:
            raise KeyError(f"dataset '{cfg.name}' waits for a later slice of the port")
        raise KeyError(f"unknown dataset '{cfg.name}'; known: {sorted(_DATASETS)}")
    if split_file is None:
        fname = "train_files.txt" if training else "val_files.txt"
        split_file = split_file_path(cfg.split, fname)
    filenames = readlines(split_file)
    return cls(
        data_path=cfg.in_path,
        filenames=filenames,
        height=cfg.height,
        width=cfg.width,
        frame_ids=cfg.frame_ids if training else (0,),
        cfg=cfg,
        is_train=training,
        img_ext=".png" if cfg.png else ".jpg",
        gt_depth_path=None if training else (cfg.gt_depth_path or None),
    )
