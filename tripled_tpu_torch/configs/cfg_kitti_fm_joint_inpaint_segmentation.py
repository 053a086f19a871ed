"""Segmentation probe over the depth-pretrained encoder on Cityscapes, 20
classes (`configs/cfg_kitti_fm_joint_inpaint_segmentation.py`); the
segmentation CLIs build `tripled_tpu_torch.models.segmentation`'s models
over this model config's encoders."""
import dataclasses

from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_inpaint", depth_layers=50, height=192, width=640,
    dataset="kitti_inpaint", erase_count=16,
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
)
config = dataclasses.replace(
    config,
    data=dataclasses.replace(config.data, name="cityscapes"),
    work_dir="work/segmentation",
)
SEGMENTATION_MODEL = "FixSegmentationDepth"
NUM_CLASSES = 20
