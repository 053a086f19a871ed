"""`mono_fm_joint_inpaint_disentangle_distill_sep_colorize` with
`cond_encoder=True`: the depth embedding is added to each stage of the
colorize encoder, which has the depth encoder's stage widths (both R18, no
stage split). One step in float64 with automask off against the JAX step,
as `test_torch_port_distill_gs_steps.py` says (TOL_F64), cut as its CUT
says (one source frame, scale 0, 64x96) and without the extractor
(perception_weight 0): the setting feeds the colorize encoder alone, and
`test_torch_port_distill_sep_colorize_steps.py` holds the preset at its
shipped values, with the extractor. No shipped config sets cond_encoder.
"""

import torch

from test_torch_port_distill_gs_steps import hold_f64

torch.set_num_threads(1)


def test_sep_colorize_cond_encoder_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_disentangle_distill_sep_colorize", cut=True,
             cond_encoder=True, perception_weight=0.0)
