"""One training step of each distillation preset in tripled_tpu_torch
against the JAX package's step on the CPU, through `run_both` /
`check_against_jax` (`test_torch_port_step.py`). This file holds
`mono_fm_joint_inpaint_distill_gs` in float64 with automask off, cut as
CUT says, and the
helpers of the other step files, one or two steps each (a float64 step
with the extractor takes 85-90 s on one CPU worker at the sizes below,
most of it the JAX step's trace and compile; cut as CUT says, 65-90 s
with it and 45-50 s without):
- `test_torch_port_distill_colorize_steps.py`: `_distill_colorize`, f64, CUT;
- `test_torch_port_disentangle_distill_colorize_steps.py`: f64, CUT;
- `test_torch_port_disentangle_distill_colorize_f32.py`: f32, automask on;
- `test_torch_port_distill_bf16.py`: bf16 against the JAX bf16 step;
- `test_torch_port_distill_sep_colorize_steps.py`: f64, CUT;
- `test_torch_port_distill_sep_colorize_cond_steps.py`: f64, `cond_encoder`,
  CUT, no extractor;
- `test_torch_port_distill_sep_inpaint_steps.py`: f64, CUT, no extractor;
- `test_torch_port_distill_sep_inpaint_f32.py`: f32, automask on, one
  source frame, scale 0.

Every step is the small flagship of `test_torch_port_flagship.py` (R18
everywhere, 64x160, the pose net at 32x96, batch 2, 6 erased 8x8 squares
per sample, decoder dropout off) with the preset's name and the values its
shipped config sets (`configs/cfg_kitti_fm_joint_inpaint_*distill*.py`):
here perception_weight 0, which leaves the step without an extractor or
an ImageDecoder, and d2g_weight 5e-3 on the Lab L target, or
colorize_weight 5e-3.

Tolerances are `test_torch_port_flagship_f64.py`'s (TOL_F64): the terms
that both packages reduce in float32 (smoothness, perceptual, auto_res and
the four distillation terms, each a `perceptional_loss`, and the total)
rtol 5e-6, the rest 1e-12; each tensor's gradient within 1e-9 of its norm;
the parameters after the update within 1e-6 * lr; BatchNorm statistics of
every network within 1e-12. Seen over the six float64 steps: the
distillation terms 6.7e-8 to 5.2e-7 (their float32 means, summed in
another order), the other float32-reduced terms up to 2.7e-6, the rest
1.7e-15; each tensor's gradient within 1.1e-12 of its norm; statistics
6.4e-15. The six cut files: float32-reduced terms up to 1.3e-6, the rest
4.8e-16, gradients within 3.2e-13 of their norms, statistics 4.4e-15.
"""

import jax
import numpy as np
import torch

from test_torch_port_flagship import flagship_inputs, flagship_kwargs
from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import check_against_jax, run_both

torch.set_num_threads(1)

SHIPPED = {
    "mono_fm_joint_inpaint_distill_gs": dict(perception_weight=0.0, d2g_weight=5e-3,
                                             use_lab=True, use_normal=False),
    "mono_fm_joint_inpaint_distill_colorize": dict(perception_weight=0.0, colorize_weight=5e-3,
                                                   use_normal=False, use_mask=False),
    "mono_fm_joint_inpaint_disentangle_distill_colorize": dict(
        perception_weight=1e-3, auto_res_weight=5e-3, colorize_weight=5e-3),
    "mono_fm_joint_inpaint_disentangle_distill_sep_colorize": dict(
        perception_weight=1e-3, auto_res_weight=5e-3, colorize_weight=5e-3,
        colorize_num_layers=18),
    "mono_fm_joint_inpaint_disentangle_distill_sep_inpaint": dict(
        perception_weight=1e-3, auto_res_weight=5e-3, inpaint_weight=5e-3,
        inpaint_num_layers=18),
}

# each preset's new loss term
NEW_TERM = {
    "mono_fm_joint_inpaint_distill_gs": "depth_to_gray_loss",
    "mono_fm_joint_inpaint_distill_colorize": "colorize_loss",
    "mono_fm_joint_inpaint_disentangle_distill_colorize": "colorize_loss",
    "mono_fm_joint_inpaint_disentangle_distill_sep_colorize": "distill_colorize_loss",
    "mono_fm_joint_inpaint_disentangle_distill_sep_inpaint": "distill_inpaint_loss",
}


def distill_kwargs(name, automask=False, **extra):
    """The small flagship's sizes with the preset's name and shipped values;
    no stage is split (every distillation config sets disentangle_layers
    all False), so there is no ColorDecoder and no auto_res term."""
    kw = dict(flagship_kwargs(automask), name=name,
              disentangle_layers=(False, False, False, False, False))
    return {**kw, **SHIPPED[name], **extra}


def expected_keys(name, extractor, scales=range(4)):
    """The port's loss keys in order: the extractor's terms, per scale the
    reconstructions and smoothness, the preset's term, the total."""
    keys = ([f"feature_regularization_loss/{i}" for i in range(5)] + ["min_perceptional_loss"]
            if extractor else [])
    per_scale = (("img_reconstruct_loss",) if extractor else ()) + (
        "min_reconstruct_loss", "smooth_loss")
    keys += [f"{k}/{s}" for s in scales for k in per_scale]
    return keys + [NEW_TERM[name], "loss", "grad_norm"]


# The cut of the step files that hold a separate encoder-decoder pair or a
# setting of one preset (the JAX step's trace and compile are most of each
# file's time, and they grow with the frames and scales the loss runs
# over): one source frame and scale 0 alone, at 64x96. The preset's own
# term reads the target frame and the disparities of all four scales,
# which the depth decoder still gives.
CUT = dict(frame_ids=(0, 1), scales=(0,), height=64, width=96)


def cut_inputs(dtype):
    return flagship_inputs(dtype, CUT["height"], CUT["width"], sources=1)


def hold_f64(name, cut=False, **extra):
    """One float64 step of the preset at its shipped values with `extra`,
    cut as CUT says where `cut`."""
    kwargs = distill_kwargs(name, **extra, **(CUT if cut else {}))
    with jax.enable_x64(True):
        jm, tm, *rest = run_both(kwargs, dtype=np.float64,
                                 inputs=cut_inputs(np.float64) if cut
                                 else flagship_inputs(np.float64))
    assert list(tm) == expected_keys(name, kwargs["perception_weight"] > 0,
                                     kwargs.get("scales", range(4)))
    check_against_jax(jm, tm, *rest, automask=False, tol=TOL_F64)
    return tm


def test_distill_gs_step_float64_matches_jax():
    hold_f64("mono_fm_joint_inpaint_distill_gs", cut=True)
