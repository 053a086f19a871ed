"""Training steps of tripled_tpu_torch's architecture options against the
JAX package's, on the CPU in float64, automask off, with the helpers of
the other variant step files. This file: the disentangle preset (R18
everywhere, 64x96, the pose net at 32x96, batch 2, six 8x8 erased squares,
dropout off, no extractor) with every skip option at once: ASCA attention
on every depth skip, the 1x1 split of the disentangled last stage, the 1x1
colour skips on stages 1 and 3, pose from prediction, and the
pixel-shuffle depth decoder.

Cut to fit the CPU test budget (the JAX step's trace and compile are most
of each file's time), in both packages alike: one source frame (frame ids
0, 1) and, where the option lies before the decoder's heads, scale 0
alone; the disparities of all four scales still feed the colour decoder.

Tolerances are `test_torch_port_flagship_f64.py`'s (TOL_F64). The colour
skips of stages 1 and 3 feed no decoder input (the colour decoder's skips
read stages 2 and 0 under color_skip_layers (F, T, F, T)): they get no
gradient in either package, and their BatchNorm statistics still move.
"""

import jax
import numpy as np
import torch

from test_torch_port_flagship import flagship_kwargs
from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import check_against_jax, make_inputs, run_both
from tripled_tpu.data.transforms import make_erase_mask

torch.set_num_threads(1)

H, W = 64, 96


def variant_kwargs(**options):
    """The small flagship at 64x96 with one source frame, without its
    extractor (perception_weight 0: no feature terms, no image decoder) or
    colour decoder (auto_res_weight 0), automask off, scale 0 alone, with
    `options`."""
    return {**flagship_kwargs(automask=False), "height": H, "width": W, "frame_ids": (0, 1),
            "scales": (0,), "perception_weight": 0.0, "auto_res_weight": 0.0, **options}


def variant_inputs(erase=True):
    """make_inputs at 64x96 with one source frame; with `erase`, six 8x8
    erased squares per sample."""
    rng = np.random.RandomState(5)
    mask = np.stack([make_erase_mask(rng, H, W, (8, 8), 6) for _ in range(2)]) if erase else None
    inputs = make_inputs(np.float64, H, W, mask=mask)
    for key in ("color", "color_aug"):
        inputs[key] = inputs[key][:, :2]
    return inputs


def variant_keys(scales=(0,), auto_res=False):
    keys = [f"{k}/{s}" for s in scales for k in ("min_reconstruct_loss", "smooth_loss")]
    return keys + (["auto_res_loss"] if auto_res else []) + ["loss", "grad_norm"]


def hold_variant_f64(kwargs, keys, erase=True, tol=TOL_F64):
    """One float64 step of `kwargs` in both packages on `variant_inputs`,
    held within `tol`; returns the port's metrics and model after the step."""
    with jax.enable_x64(True):
        jm, tm, *rest = run_both(kwargs, dtype=np.float64, inputs=variant_inputs(erase))
    assert list(tm) == keys
    check_against_jax(jm, tm, *rest, automask=False, tol=tol)
    return tm, rest[0]


def test_asca_1x1_split_color_skips_pfp_shuffle_step_float64_matches_jax():
    kw = variant_kwargs(depth_skip_type="asca", depth_disentangle_type="1x1",
                        color_skip_type="1x1", color_skip_layers=(False, True, False, True),
                        use_pfp=True, depth_use_shuffle=True, auto_res_weight=5e-3)
    _, model = hold_variant_f64(kw, variant_keys(auto_res=True))
    assert len(model.depth_decoder.shuffles) == 3
    assert [hasattr(s, "conv") for s in model.color_skips] == [False, True, False, True, False]
    # the unread colour skips: no gradient, statistics moved
    assert model.color_skips[1].conv.weight.grad is None
    assert model.color_skips[1].bn.num_batches_tracked.item() == 1
