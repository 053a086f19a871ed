"""`mono_fm_joint_equivariant_inpaint`: the erase mask warped (nearest)
into each source frame at each scale, the ImageDecoder's decoding of the
warped source features, `min_equivariant_loss/{s}`, and no perceptual term.
One step in float64 against the JAX step, as
`test_torch_port_pretext_steps.py` says (TOL_F64). The inpaint mask also
erases a 2-pixel border: the random networks' poses send the mask warp's
samples out of the image, where the border clamps them, and an erase mask
kept whole there would leave nothing erased in the warped masks and the
term at its guarded 0.
"""

import torch

from test_torch_port_pretext_steps import hold_f64, pretext_inputs

torch.set_num_threads(1)


def test_equivariant_step_float64_matches_jax():
    tm = hold_f64("mono_fm_joint_equivariant_inpaint", inputs=pretext_inputs(erase_border=True))
    assert all(tm[f"min_equivariant_loss/{s}"] > 0 for s in range(4))
