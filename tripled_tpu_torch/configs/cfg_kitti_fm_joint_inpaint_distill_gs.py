"""Grayscale-distillation head, d2g 5e-3, Lab L target (ref cfg)
(`configs/cfg_kitti_fm_joint_inpaint_distill_gs.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_inpaint_distill_gs", depth_layers=50,
    height=192, width=640, dataset="kitti_inpaint", erase_count=16,
    dis=1e-3, cvt=1e-3, perception_weight=0.0, smoothness_weight=1e-3,
    d2g_weight=5e-3, use_lab=True, use_normal=False,
)
