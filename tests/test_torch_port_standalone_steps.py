"""The standalone pretext models, `autoencoder`, `inpainter` (the masked
autoencoder) and `rotnet`, one step each in float64 against the JAX step,
as `test_torch_port_pretext_steps.py` says (TOL_F64), with the same fixed
crop offset and rotation labels in both packages. Their JAX steps are
small (an R18 extractor, and the ImageDecoder or a dense head), so the
three share a file. The autoencoder and the inpainter run at 64x96 (they
read the target frame alone); rotnet at the pretext steps' 64x160, where
the fixed crop offset lies.
"""

import pytest
import torch

from test_torch_port_pretext_steps import fixed_draws, hold_f64, pretext_inputs  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["autoencoder", "inpainter", "rotnet"])
def test_standalone_step_float64_matches_jax(name, fixed_draws):  # noqa: F811
    if name == "rotnet":
        tm = hold_f64(name)
    else:
        tm = hold_f64(name, inputs=pretext_inputs(h=64, w=96), height=64, width=96,
                      pose_width=64)
    assert tm["loss"] > 0
