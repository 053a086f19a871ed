"""HR-Depth's decoder (use_hr_depth) in the float64 training step against
the JAX package's, on the CPU: mono_baseline with R18 depth and pose at
64x96, the pose net at 32x96, batch 2, one source frame, scale 0 (the
full-size head, which every position of the nested grid feeds), automask
off, held within TOL_F64: every loss term, each parameter's gradient
(the other three heads get none), the parameters after Adam and the
BatchNorm statistics. Cut so to fit the CPU test budget: the extractor
and image decoder of mono_fm_joint do not meet the depth decoder but
through the disparity, the four heads are held by the decoder's module
test and the eval test, and `chip_smoke.py` drives the mono_fm_joint row
on the card."""

import torch

from test_torch_port_variant_asca_steps import hold_variant_f64, variant_keys, variant_kwargs

torch.set_num_threads(1)



def test_hr_depth_step_float64_matches_jax():
    kw = variant_kwargs(name="mono_baseline", disentangle_layers=(False,) * 5, use_hr_depth=True)
    _, model = hold_variant_f64(kw, variant_keys(), erase=False)
    assert type(model.depth_decoder).__name__ == "HRDepthDecoder"
