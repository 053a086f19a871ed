"""One mixed-precision (`compute_dtype="bfloat16"`) step of
`mono_fm_joint_inpaint_disentangle_distill_colorize` against the JAX
package's bf16 step on the CPU, at the sizes and shipped values of
`test_torch_port_distill_gs_steps.py`, automask on. As in JAX, the colorize
head is fed the float32 disparity and Lab L and computes in float32 on
bf16-rounded parameters; its output and loss stay float32. Tolerances are
`test_torch_port_bf16.py`'s BF16_TOL, unchanged.

Seen on the CPU: colorize_loss 9.4e-7 from the JAX bf16 step, the other
terms within 1.6e-3 but the smoothness terms (8.0e-3 to 1.1e-2), the
gradient norm 3.7e-3, each tensor's gradient within 0.59 of its norm
(median 0.11). One term misses
its bound: smooth_loss/3 is 5.07e-2 from the JAX bf16 step against
BF16_TOL's 5e-2, so this test fails. It is bf16 rounding, not a different
function: the JAX bf16 step's smooth_loss/3 is 2.67% from the JAX float32
step's, the port's 2.53% from the port's float32 step's, on the other
side (the float32 steps agree to 2e-5). The term sums the differences
between neighbours of a nearly flat 4x10 disparity, a few bf16 steps
each, and is 5e-6 of a total loss of 0.8.
"""

import torch

from test_torch_port_bf16 import bf16_kwargs, check
from test_torch_port_distill_gs_steps import distill_kwargs, expected_keys
from test_torch_port_flagship import flagship_inputs
from test_torch_port_step import run_both

torch.set_num_threads(1)


def test_disentangle_distill_colorize_bf16_step_matches_jax():
    name = "mono_fm_joint_inpaint_disentangle_distill_colorize"
    jm, tm, *rest = run_both(bf16_kwargs(distill_kwargs(name, automask=True)),
                             inputs=flagship_inputs())
    assert list(tm) == expected_keys(name, extractor=True)
    check(jm, tm, *rest)
