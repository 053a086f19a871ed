"""`mono_fm_joint_inpaint_disentangle_distill_sep_inpaint`: one step in
float64 with automask off against the JAX step, as
`test_torch_port_distill_gs_steps.py` says (sizes, shipped values,
TOL_F64), cut as its CUT says (one source frame, scale 0, 64x96) and
without the extractor (perception_weight 0), which the preset's own term
does not read: the float64 flagship and disentangle_distill_colorize steps
hold the extractor, and `test_torch_port_distill_sep_inpaint_f32.py` this
preset with it. The preset forces auto_res_weight to 0; the inpaint
encoder (R18, as its config) takes the erased target, its decoder the
disparities.
"""

import torch

from test_torch_port_distill_gs_steps import hold_f64

torch.set_num_threads(1)


def test_sep_inpaint_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_disentangle_distill_sep_inpaint", cut=True,
             perception_weight=0.0)
