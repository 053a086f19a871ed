"""Plain image-folder training (`configs/cfg_folder.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_baseline", depth_layers=18, height=192, width=640,
    dataset="folder", perception_weight=0.0, smoothness_weight=1e-3,
)
