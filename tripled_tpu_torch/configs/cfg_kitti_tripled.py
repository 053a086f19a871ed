"""TripleDNet flagship: mono_fm_joint_inpaint_disentangle, R50, 320x1024,
batch 12, the last encoder stage disentangled, auto_res 5e-3, 20 epochs
(`configs/cfg_kitti_tripled.py`). It sets remat, which the port does not
apply yet: without it the step holds 45.4 GiB on an H100 80GB HBM3
(PERF.md)."""
from tripled_tpu_torch.configs._common import kitti_experiment

config = kitti_experiment(
    "mono_fm_joint_inpaint_disentangle", depth_layers=50,
    height=320, width=1024, remat=True, batch_size=12, dataset="kitti_inpaint",
    erase_count=16, total_epochs=20, lr_steps=(10, 20),
    dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
    auto_res_weight=5e-3,
    disentangle_layers=(False, False, False, False, True),
    skip_connection_multiplier=1.0,
    depth_disentangle_type="use_half",
)
