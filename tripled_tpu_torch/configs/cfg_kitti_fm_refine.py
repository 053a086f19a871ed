"""Online refinement: mono_fm on the test sequence (`configs/cfg_kitti_fm_refine.py`)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm", depth_layers=50, height=320, width=1024, remat=True, split="test",
    total_epochs=60, perception_weight=1e-3, smoothness_weight=1e-3,
)
