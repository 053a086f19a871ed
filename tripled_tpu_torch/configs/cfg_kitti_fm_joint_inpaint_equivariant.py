"""Equivariant inpaint pretext, weight 1e-3 (ref cfg)
(`configs/cfg_kitti_fm_joint_inpaint_equivariant.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_equivariant_inpaint", depth_layers=18, extractor_layers=18,
    height=192, width=640, dataset="kitti_map", erase_count=16,
    map_alphas=(0.1, 0.4, 0.7, 1.0),
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
    equivariant_weight=1e-3,
)
