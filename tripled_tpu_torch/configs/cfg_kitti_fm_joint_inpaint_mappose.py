"""Map-pose pretext: alphas (0.1,0.4,0.7,1.0), 16 classes, weight 0.5 (ref)
(`configs/cfg_kitti_fm_joint_inpaint_mappose.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

ALPHAS = (0.1, 0.4, 0.7, 1.0)
config = kitti_experiment(
    "mono_fm_joint_inpaint_map_pose", depth_layers=18, extractor_layers=18,
    height=192, width=640, dataset="kitti_map", erase_count=16,
    map_alphas=ALPHAS,
    dis=1e-3, cvt=1e-3, perception_weight=0.0, smoothness_weight=1e-3,
    map_output=len(ALPHAS) ** 2, map_pose_weight=0.5,
)
