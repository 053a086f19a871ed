"""`mono_fm_joint_im_rot`: the extractor on a rotated 48-pixel crop of the
target with `rot_head` and `ssl_rot_loss`, and the crop-matched perceptual
term. One step in float64 against the JAX step, as
`test_torch_port_pretext_steps.py` says (TOL_F64), with the same fixed
crop offset and rotation labels in both packages, cut to one source frame
and scale 0 (the JAX step's trace and compile grow with them; the
rotation pretext reads the target alone).
"""

import torch

from test_torch_port_pretext_steps import fixed_draws, hold_f64, pretext_inputs  # noqa: F401

torch.set_num_threads(1)


def test_im_rot_step_float64_matches_jax(fixed_draws):  # noqa: F811
    tm = hold_f64("mono_fm_joint_im_rot", inputs=pretext_inputs(sources=1), frame_ids=(0, 1),
                  scales=(0,))
    assert tm["ssl_rot_loss"] > 0 and tm["min_perceptional_loss"] > 0
