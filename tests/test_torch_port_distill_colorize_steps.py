"""`mono_fm_joint_inpaint_distill_colorize`: one step in float64 with
automask off against the JAX step, as `test_torch_port_distill_gs_steps.py`
says (sizes, shipped values, TOL_F64), cut as its CUT says (one source
frame, scale 0, 64x96). perception_weight 0: no extractor; the colorize
head sees the full-resolution disparity and Lab L and predicts ab.
"""

import torch

from test_torch_port_distill_gs_steps import hold_f64

torch.set_num_threads(1)


def test_distill_colorize_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_distill_colorize", cut=True)
