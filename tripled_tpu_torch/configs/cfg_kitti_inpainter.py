"""Standalone inpainter pretraining (ref cfg_kitti_inpainter)
(`configs/cfg_kitti_inpainter.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "inpainter", extractor_layers=50, height=320, width=1024, remat=True,
    dataset="kitti_inpaint", erase_count=16, total_epochs=30,
    dis=1e-3, cvt=1e-3,
)
