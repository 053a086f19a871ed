"""The disentangle preset's float64 training step with
depth_skip_type="1x1" against the JAX package's, on the CPU: stage 3
disentangled through the 1x1 split (depth_disentangle_type="1x1") and the
undivided last stage through the full-width 1x1 block (`full_1x1`), on the
small flagship of `test_torch_port_variant_asca_steps.py` (no
extractor, no colour decoder, one source frame, scale 0), held within
TOL_F64."""

import torch

from test_torch_port_variant_asca_steps import hold_variant_f64, variant_keys, variant_kwargs

torch.set_num_threads(1)


def test_1x1_skip_with_full_last_stage_step_float64_matches_jax():
    kw = variant_kwargs(depth_skip_type="1x1", depth_disentangle_type="1x1",
                        disentangle_layers=(False, False, False, True, False))
    _, model = hold_variant_f64(kw, variant_keys())
    convs = [s.conv.weight.shape[:2] if hasattr(s, "conv") else None for s in model.depth_skips]
    assert convs == [None, None, None, (128, 256), (512, 512)]
