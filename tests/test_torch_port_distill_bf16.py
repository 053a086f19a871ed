"""One mixed-precision (`compute_dtype="bfloat16"`) step of
`mono_fm_joint_inpaint_disentangle_distill_colorize` against the JAX
package's bf16 step on the CPU, at the sizes and shipped values of
`test_torch_port_distill_gs_steps.py`, automask on. As in JAX, the colorize
head is fed the float32 disparity and Lab L and computes in float32 on
bf16-rounded parameters; its output and loss stay float32. Tolerances are
`test_torch_port_bf16.py`'s BF16_TOL, unchanged.

Seen on the CPU: colorize_loss 1.0e-6 from the JAX bf16 step, the other
terms within 2.2e-3 but the smoothness terms (9.1e-3 to 3.1e-2), the
gradient norm 4.6e-4, each tensor's gradient within 0.34 of its norm
(median 0.087), BatchNorm statistics within 8.7e-4. The smoothness terms
sum the differences between neighbours of a nearly flat disparity, a few
bf16 steps each, and smooth_loss/3 (a 4x10 map) sits at the noise floor
that float32 summation order inside the convolutions leaves: it stood
5.07e-2 from the JAX step while the port normalised the bf16 image with
float32 constants, rounded each bf16 convolution's output before
BatchNorm and used a float32 leaky-ReLU slope, where XLA computing the
JAX step does none of these (`models/encoders.py`, `models/layers.py` `conv_bn`,
`models/depth_decoder.py`); 2.0e-2 since.
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
