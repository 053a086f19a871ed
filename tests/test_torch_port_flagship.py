"""One step of the flagship, TripleDNet (mono_fm_joint_inpaint_disentangle),
in tripled_tpu_torch against the JAX package's step on the CPU, in float32.

The model is cut to R18 depth / R18 pose / R18 extractor at 64x160 with
the pose net at 32x96 (a factor of 0.6 along the width, so the pose
input goes through a non-integer bilinear resize), batch 2, decoder
dropout off, and a fixed mask of erased squares. Everything else is the
flagship's: the joint extractor with its ImageDecoder and feature
regularisation, the inpaint-masked reconstruction, the last encoder stage
split between the depth decoder and the ColorDecoder, auto_res_loss, and
automask. The JAX step runs its XLA path; the port runs the plain version
of its photometric kernel.

Tolerances are those of `test_torch_port_step.py` (TOL_F32: loss terms
rtol 2e-5, gradient norm rtol 1e-3, each tensor's gradient within 5e-2 of
its norm, at most 3% of the moved elements flipped by the first Adam
step, BatchNorm statistics 1e-5, the extractor's included), with one
addition: the JAX step's XLA path adds N(0, 1e-5) noise to the identity
losses as a tie-break, while the port takes the first candidate on a tie
and adds none, so `min_reconstruct_loss/*` and the total are held at atol
2e-5 instead.
"""

import numpy as np
import torch

from test_torch_port_step import check_against_jax, make_inputs, run_both
from tripled_tpu.data.transforms import make_erase_mask

torch.set_num_threads(1)

B, H, W = 2, 64, 160


def flagship_kwargs(automask=True):
    return dict(name="mono_fm_joint_inpaint_disentangle", depth_num_layers=18,
                pose_num_layers=18, extractor_num_layers=18, height=H, width=W,
                pose_height=32, pose_width=96, depth_dropout_rate=0.0, automask=automask,
                dis=1e-3, cvt=1e-3, perception_weight=1e-3, smoothness_weight=1e-3,
                auto_res_weight=5e-3, disentangle_layers=(False, False, False, False, True),
                skip_connection_multiplier=1.0, depth_disentangle_type="use_half")


def flagship_inputs(dtype=np.float32, h=H, w=W, sources=2):
    """make_inputs with six 8x8 erased squares per sample; at another size
    (h, w) or with fewer source frames where the step files cut them."""
    rng = np.random.RandomState(5)
    mask = np.stack([make_erase_mask(rng, h, w, (8, 8), 6) for _ in range(B)])
    inputs = make_inputs(dtype, h, w, mask=mask)
    for key in ("color", "color_aug"):
        inputs[key] = inputs[key][:, :1 + sources]
    return inputs


def expected_keys(scales=range(4)):
    return ([f"feature_regularization_loss/{i}" for i in range(5)] + ["min_perceptional_loss"]
            + [f"{k}/{s}" for s in scales
               for k in ("img_reconstruct_loss", "min_reconstruct_loss", "smooth_loss")]
            + ["auto_res_loss", "loss", "grad_norm"])


EXPECTED_KEYS = expected_keys()


def test_flagship_step_matches_jax():
    jm, tm, *rest = run_both(flagship_kwargs(), inputs=flagship_inputs())
    assert list(tm) == EXPECTED_KEYS
    check_against_jax(jm, tm, *rest, automask=True)
