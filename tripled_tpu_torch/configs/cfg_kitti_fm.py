"""FeatDepth (mono_fm): R50 depth / R18 pose @320x1024 (`configs/cfg_kitti_fm.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm", depth_layers=50, height=320, width=1024, remat=True,
    perception_weight=1e-3, smoothness_weight=1e-3,
)
