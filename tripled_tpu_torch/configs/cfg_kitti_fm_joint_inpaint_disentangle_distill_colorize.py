"""Disentangle + colorize distillation (ref cfg)
(`configs/cfg_kitti_fm_joint_inpaint_disentangle_distill_colorize.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_inpaint_disentangle_distill_colorize", depth_layers=50,
    height=192, width=640, dataset="kitti_inpaint", erase_count=16,
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
    auto_res_weight=5e-3, colorize_weight=5e-3,
    disentangle_layers=(False, False, False, False, False),
)
