"""The mono_fm step of `test_torch_port_step.py` with automask on, in
float32, against the JAX package's step on the CPU.

The JAX step's XLA path adds N(0, 1e-5) noise to the identity losses as a
tie-break; the port, like the JAX package's Pallas kernel, takes the first
candidate on a tie and adds no noise. The reconstruction terms and the
total may differ by the noise: atol 2e-5 on terms of about 0.1. The other
tolerances are those stated in `test_torch_port_step.py`.
"""

import torch

from test_torch_port_step import check_against_jax, mono_fm_kwargs, run_both

torch.set_num_threads(1)


def test_mono_fm_step_automask_matches_jax():
    check_against_jax(*run_both(mono_fm_kwargs(automask=True)), automask=True)
