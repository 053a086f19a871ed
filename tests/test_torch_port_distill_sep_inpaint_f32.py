"""`mono_fm_joint_inpaint_disentangle_distill_sep_inpaint` in float32 with
automask on, against the JAX step, at the sizes of
`test_torch_port_distill_gs_steps.py` with one source frame and scale 0
alone (at 64x160: at CUT's 64x96 the first Adam step flips more than
TOL_F32's 3% of the moved elements), with use_distill_mask on as well
(no shipped config sets it): the inpaint loss is the mean over the erased
pixels. Tolerances are `test_torch_port_step.py`'s TOL_F32 (the JAX step's
N(0, 1e-5) tie-break noise held at atol 2e-5 on the reconstruction terms
and the total), as `test_torch_port_flagship.py`. Seen: the
float32-reduced terms up to 1.2e-6, each tensor's gradient within 2.0e-3
of its norm, 1.3% of the moved elements flipped, statistics 1.3e-6 (with
both source frames and four scales: 1.4e-6, 1.9e-4, 0.2%, 1.3e-6).
"""

import numpy as np
import torch

from test_torch_port_distill_gs_steps import distill_kwargs, expected_keys
from test_torch_port_flagship import flagship_inputs
from test_torch_port_step import check_against_jax, run_both

torch.set_num_threads(1)


def test_sep_inpaint_step_float32_matches_jax():
    name = "mono_fm_joint_inpaint_disentangle_distill_sep_inpaint"
    jm, tm, *rest = run_both(distill_kwargs(name, automask=True, use_distill_mask=True,
                                            frame_ids=(0, 1), scales=(0,)),
                             inputs=flagship_inputs(np.float32, sources=1))
    assert list(tm) == expected_keys(name, extractor=True, scales=(0,))
    check_against_jax(jm, tm, *rest, automask=True)
