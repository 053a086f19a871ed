"""`mono_fm_joint_inpaint_disentangle_distill_colorize` in float32 with
automask on, against the JAX step, at the sizes of
`test_torch_port_distill_gs_steps.py`, with use_normal and use_mask on as
well (no shipped config sets them; `test_torch_port_distill.py` holds them
one by one): the colorize head sees the erased disparity, surface normal
and Lab L, and is scored on the erased pixels. Tolerances are
`test_torch_port_step.py`'s TOL_F32 (the JAX step's N(0, 1e-5) tie-break
noise held at atol 2e-5 on the reconstruction terms and the total), as
`test_torch_port_flagship.py`. Seen: colorize_loss 1.3e-6, the other
float32-reduced terms up to 4.0e-6, each tensor's gradient within 6.7e-3
of its norm, statistics 9.5e-7.
"""

import torch

from test_torch_port_distill_gs_steps import distill_kwargs, expected_keys
from test_torch_port_flagship import flagship_inputs
from test_torch_port_step import check_against_jax, run_both

torch.set_num_threads(1)


def test_disentangle_distill_colorize_step_float32_matches_jax():
    name = "mono_fm_joint_inpaint_disentangle_distill_colorize"
    jm, tm, *rest = run_both(distill_kwargs(name, automask=True, use_normal=True, use_mask=True),
                             inputs=flagship_inputs())
    assert list(tm) == expected_keys(name, extractor=True)
    check_against_jax(jm, tm, *rest, automask=True)
