"""The standalone pretext models, `autoencoder`, `inpainter` (the masked
autoencoder) and `rotnet`, one step each in float64 against the JAX step,
as `test_torch_port_pretext_steps.py` says (TOL_F64), with the same fixed
crop offset and rotation labels in both packages. Their JAX steps are
small (an R18 extractor, and the ImageDecoder or a dense head), so the
three share a file.
"""

import pytest
import torch

from test_torch_port_pretext_steps import fixed_draws, hold_f64  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["autoencoder", "inpainter", "rotnet"])
def test_standalone_step_float64_matches_jax(name, fixed_draws):  # noqa: F811
    tm = hold_f64(name)
    assert tm["loss"] > 0
