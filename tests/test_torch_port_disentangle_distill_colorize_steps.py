"""`mono_fm_joint_inpaint_disentangle_distill_colorize`: one step in float64
with automask off against the JAX step, as
`test_torch_port_distill_gs_steps.py` says (sizes, shipped values,
TOL_F64), cut as its CUT says (one source frame, scale 0, 64x96). The
joint extractor with its ImageDecoder and the colorize head; its config
splits no stage, so no ColorDecoder and no auto_res term, although
auto_res_weight is 5e-3. "disentangle" in the name: the extractor sees
the whole target, not the erased one.
"""

import torch

from test_torch_port_distill_gs_steps import hold_f64

torch.set_num_threads(1)


def test_disentangle_distill_colorize_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_disentangle_distill_colorize", cut=True)
