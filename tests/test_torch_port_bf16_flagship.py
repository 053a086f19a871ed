"""One mixed-precision (`compute_dtype="bfloat16"`) step of the flagship,
TripleDNet, in tripled_tpu_torch against the JAX package's bf16 step on the
CPU: the small flagship of `test_torch_port_flagship.py` (R18 everywhere,
64x160, pose net at 32x96, batch 2, automask on, decoder dropout off, a
fixed mask of erased squares), with `compute_dtype="bfloat16"` in both
packages. Tolerances and the numbers seen are in `test_torch_port_bf16.py`
(BF16_TOL); the JAX step's N(0, 1e-5) tie-break noise on the identity
losses lies far inside them.
"""

import torch

from test_torch_port_bf16 import bf16_kwargs, check
from test_torch_port_flagship import EXPECTED_KEYS, flagship_inputs, flagship_kwargs
from test_torch_port_step import run_both

torch.set_num_threads(1)


def test_flagship_bf16_step_matches_jax():
    jm, tm, *rest = run_both(bf16_kwargs(flagship_kwargs()), inputs=flagship_inputs())
    assert list(tm) == EXPECTED_KEYS
    check(jm, tm, *rest)
