"""Standalone autoencoder pretraining @320x1024 (ref cfg_kitti_autoencoder)
(`configs/cfg_kitti_autoencoder.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "autoencoder", extractor_layers=50, height=320, width=1024, remat=True,
    total_epochs=30, dis=1e-3, cvt=1e-3,
)
