"""The stereo frame's float64 training step in tripled_tpu_torch against
the JAX package's, on the CPU: frame ids (0, -1, "s") with
`configs/_common.py`'s stereo values (automask and disp_norm off), on the
small flagship of `test_torch_port_variant_asca_steps.py` (R18, 64x96, the
pose net at 32x96, batch 2, six 8x8 erased squares, dropout off, no
extractor, no colour decoder, scale 0), held within TOL_F64. The temporal
source is warped by its predicted pose, the stereo one by `stereo_T` (a
0.015 baseline in x, its sign flipped in the second sample, as a flipped
or right-camera sample has it); the pose net runs once, for the temporal
pair."""

import jax
import numpy as np
import torch

from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import check_against_jax, make_inputs, run_both
from test_torch_port_variant_asca_steps import H, W, variant_keys, variant_kwargs
from tripled_tpu.data.transforms import make_erase_mask

torch.set_num_threads(1)


def stereo_inputs():
    rng = np.random.RandomState(5)
    mask = np.stack([make_erase_mask(rng, H, W, (8, 8), 6) for _ in range(2)])
    inputs = make_inputs(np.float64, H, W, mask=mask)
    stereo_T = np.tile(np.eye(4), (2, 1, 1))
    stereo_T[:, 0, 3] = [0.015, -0.015]
    inputs["stereo_T"] = stereo_T
    return inputs


def test_stereo_step_float64_matches_jax():
    kw = variant_kwargs(frame_ids=(0, -1, "s"), automask=False, disp_norm=False)
    with jax.enable_x64(True):
        jm, tm, model, *rest = run_both(kw, dtype=np.float64, inputs=stereo_inputs())
    assert list(tm) == variant_keys()
    check_against_jax(jm, tm, model, *rest, automask=False, tol=TOL_F64)
    # the temporal pair's pose net gets a gradient
    assert sum(p.grad.norm() for p in model.pose_encoder.parameters()) > 0
