"""mono_fm_joint_inpaint: R50 @192x640, erase 16x16x16
(`configs/cfg_kitti_fm_joint_inpaint.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_inpaint", depth_layers=50, height=192, width=640,
    dataset="kitti_inpaint", erase_count=16,
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
)
