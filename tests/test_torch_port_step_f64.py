"""The mono_fm step of `test_torch_port_step.py` in float64, automask off,
against the JAX package's step on the CPU.

In float64 the max pools' near-ties fall the same way in both packages, so
the step is held tightly, tensor by tensor and element by element:
- Reconstruction terms rtol 1e-12 (seen 8e-16). The perceptual and
  smoothness terms, and the total that holds them, rtol 1e-6 (seen 2.4e-7):
  the JAX package reduces those two in float32 whatever the input dtype
  (`tripled_tpu/ops/losses.py:37,87`), the port in the input dtype.
- Gradient norm rtol 1e-10 (seen 8e-15); each tensor's gradient within
  1e-9 of its norm (seen 1.2e-13).
- Every parameter after the Adam update within 1e-6 * lr of the JAX value
  (seen 1e-7 * lr), so no element may move the other way; BatchNorm
  running statistics within 1e-12 (seen 2e-15).
"""

import jax
import numpy as np
import torch

from test_torch_port_step import check_against_jax, mono_fm_kwargs, run_both

torch.set_num_threads(1)

TOL_F64 = dict(loss=1e-12, f32_reduced_loss=1e-6, grad_norm=1e-10, grad=1e-9, param=1e-6,
               flip_share=0.0, stats=1e-12)


def test_mono_fm_step_float64_matches_jax():
    with jax.enable_x64(True):
        results = run_both(mono_fm_kwargs(automask=False), dtype=np.float64)
    check_against_jax(*results, automask=False, tol=TOL_F64)
