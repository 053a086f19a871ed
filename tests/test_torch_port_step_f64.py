"""The mono_fm step of `test_torch_port_step.py` in float64, automask off,
against the JAX package's step on the CPU, with one source frame and
scale 0 at 64x96 (the JAX step's trace and compile grow with the frames
and scales, its float64 run with the pixels; the float32 files hold both
frames and every scale at 64x128).

In float64 the max pools' near-ties fall the same way in both packages, so
the step is held tightly, tensor by tensor and element by element (seen:
with one source frame, then with two):
- Reconstruction terms rtol 1e-12 (seen 1.1e-15; 8e-16). The perceptual
  and smoothness terms, and the total that holds them, rtol 1e-6 (seen
  5.7e-7; 2.4e-7): the JAX package reduces those two in float32 whatever
  the input dtype (`tripled_tpu/ops/losses.py:37,87`), the port in the
  input dtype.
- Gradient norm rtol 1e-10 (seen 2.5e-14; 8e-15); each tensor's gradient
  within 1e-9 of its norm (seen 5.5e-14; 1.2e-13).
- Every parameter after the Adam update within 1e-6 * lr of the JAX value
  (seen 1e-7 * lr with two), so no element may move the other way;
  BatchNorm running statistics within 1e-12 (seen 3.1e-15; 2e-15).
"""

import jax
import numpy as np
import torch

from test_torch_port_step import check_against_jax, make_inputs, mono_fm_kwargs, run_both

torch.set_num_threads(1)

TOL_F64 = dict(loss=1e-12, f32_reduced_loss=1e-6, grad_norm=1e-10, grad=1e-9, param=1e-6,
               flip_share=0.0, stats=1e-12)


def test_mono_fm_step_float64_matches_jax():
    inputs = make_inputs(np.float64, h=64, w=96)
    for key in ("color", "color_aug"):
        inputs[key] = inputs[key][:, :2]
    kwargs = dict(mono_fm_kwargs(automask=False), frame_ids=(0, 1), scales=(0,), height=64,
                  width=96, pose_height=64, pose_width=96)
    with jax.enable_x64(True):
        results = run_both(kwargs, dtype=np.float64, inputs=inputs)
    check_against_jax(*results, automask=False, tol=TOL_F64)
