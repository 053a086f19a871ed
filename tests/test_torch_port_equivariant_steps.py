"""`mono_fm_joint_equivariant_inpaint`: the erase mask warped (nearest)
into each source frame at each scale, the ImageDecoder's decoding of the
warped source features, `min_equivariant_loss/{s}`, and no perceptual term.
One step in float64 against the JAX step, as
`test_torch_port_pretext_steps.py` says (TOL_F64), cut to one source frame
and scale 0 at 64x96 (the JAX step's trace and compile grow with the
frames and scales; `test_torch_port_ddp.py` runs every scale's term, on
two ranks against one process). The inpaint mask also
erases a 2-pixel border: the random networks' poses send the mask warp's
samples out of the image, where the border clamps them, and an erase mask
kept whole there would leave nothing erased in the warped masks and the
term at its guarded 0.
"""

import torch

from test_torch_port_pretext_steps import hold_f64, pretext_inputs

torch.set_num_threads(1)


def test_equivariant_step_float64_matches_jax():
    tm = hold_f64("mono_fm_joint_equivariant_inpaint",
                  inputs=pretext_inputs(erase_border=True, h=64, w=96, sources=1),
                  frame_ids=(0, 1), height=64, width=96, scales=(0,))
    assert tm["min_equivariant_loss/0"] > 0
