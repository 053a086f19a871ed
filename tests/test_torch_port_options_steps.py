"""A float64 training step of tripled_tpu_torch with every warp and kernel
option on, against the JAX package's, on the CPU: mono_fm (R18 depth and
pose, frozen R18 extractor, whose 64-channel stage-0 features take the
half-resolution warp) at 64x96, the pose net at 64x96, batch 2, one source
frame (frame ids 0, 1), scale 0, dropout off, with the block warp in (2, 4)
blocks on the colour warp and (2, 2) on the feature warp
(warp_block_features), bf16 texels, warp_align_corners=False, the eq-mask
CRP pool and the unfused photometric path with automask off. Held within
TOL_F64. Cut as `test_torch_port_variant_asca_steps.py` cuts its steps
(one source frame, scale 0, 64x96)."""

import jax
import numpy as np
import torch

from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import check_against_jax, make_inputs, mono_fm_kwargs, run_both

torch.set_num_threads(1)

H, W = 64, 96
OPTIONS = dict(warp_block_gather=True, warp_block_shape=(2, 4), warp_block_features=True,
               warp_gather_dtype="bfloat16", warp_align_corners=False, pool_eqmask_grad=True,
               use_pallas_photometric=False)


def test_every_option_step_float64_matches_jax():
    kw = {**mono_fm_kwargs(automask=False), "height": H, "width": W, "pose_height": H,
          "pose_width": W, "frame_ids": (0, 1), "scales": (0,), **OPTIONS}
    inputs = make_inputs(np.float64, H, W)
    for key in ("color", "color_aug"):
        inputs[key] = inputs[key][:, :2]
    with jax.enable_x64(True):
        jm, tm, *rest = run_both(kw, dtype=np.float64, inputs=inputs)
    assert list(tm) == ["min_perceptional_loss", "min_reconstruct_loss/0", "smooth_loss/0",
                        "loss", "grad_norm"]
    check_against_jax(jm, tm, *rest, automask=False, tol=TOL_F64)
