"""`mono_fm_joint_inpaint_disentangle_distill_sep_colorize`: one step in
float64 with automask off against the JAX step, as
`test_torch_port_distill_gs_steps.py` says (sizes, shipped values but the
colorize encoder at R18, TOL_F64), cut as its CUT says (one source frame,
scale 0, 64x96), with the extractor of its shipped values. The preset
forces auto_res_weight to 0; the colorize encoder takes Lab L in [-1, 1]
on three channels, its decoder the disparities, and the decoder's sigmoid
output is scored against ab.
"""

import torch

from test_torch_port_distill_gs_steps import hold_f64

torch.set_num_threads(1)


def test_sep_colorize_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_disentangle_distill_sep_colorize", cut=True)
