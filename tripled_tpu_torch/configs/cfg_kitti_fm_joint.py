"""mono_fm_joint: R18, 192x640 (`configs/cfg_kitti_fm_joint.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint", depth_layers=18, extractor_layers=18,
    height=192, width=640,
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
)
