"""Offline geometry / trajectory tooling (the reference's mono/tools): the
port's copy of `tripled_tpu/tools`, plain numpy."""

from tripled_tpu_torch.tools.lie import (
    so3_exp, so3_log, se3_exp, se3_log, hat, vee, sim3, is_so3, is_se3,
)
from tripled_tpu_torch.tools.trajectory import (
    align_umeyama, align_trajectory, PosePath3D,
)
from tripled_tpu_torch.tools.transformations import (
    quaternion_from_matrix, quaternion_matrix, euler_from_matrix,
    euler_matrix, quaternion_from_euler, euler_from_quaternion,
)
from tripled_tpu_torch.tools.file_interface import (
    read_tum_trajectory, write_tum_trajectory,
    read_kitti_poses, write_kitti_poses,
    read_euroc_trajectory, associate_timestamps,
)
