"""Standalone rotation-prediction pretraining (ref cfg_kitti_rotnet)
(`configs/cfg_kitti_rotnet.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "rotnet", extractor_layers=50, height=320, width=1024, remat=True, total_epochs=30,
    dis=1e-3, cvt=1e-3,
    pretext_label_size=4, pretext_resize=224, pretext_weight=1.0,
)
