"""fm_joint + rotation pretext on 224 crop @320x1024 (ref cfg)
(`configs/cfg_kitti_fm_joint_im_rot.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_im_rot", depth_layers=50, height=320, width=1024, remat=True,
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
    pretext_label_size=4, pretext_resize=224, pretext_weight=1.0,
)
