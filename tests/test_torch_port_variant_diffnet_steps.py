"""DIFFNet (use_diffnet: HRNet-18 on the raw image, the attention decoder)
in a training step against the JAX package's, on the CPU in float64, at
64x96, batch 2, the pose net at 32x96, one source frame, scale 0 (the
full-size head, which every attention stage feeds; the four heads are
held by the decoder's module test and the eval test), automask off.

Cut to fit the CPU test budget, in both packages alike:
- HRNet keeps all its layers and paths but one module per stage (1/1/1
  for 1/4/3; `_STAGE_MODULES`) and one BasicBlock per branch (for 4;
  `_BLOCKS_PER_BRANCH`), both patched for this test: the JAX package's
  float64 step of the full HRNet compiles for over two minutes, and its
  module test holds the full network (`test_torch_port_variant_hrnet.py`).
- mono_baseline, without the extractor and the image decoder, which do
  not meet the depth network but through the disparity.

Tolerances are TOL_F64 (`test_torch_port_flagship_f64.py`; seen here:
reconstruction terms 3.6e-16, gradient norm 2.6e-15, each tensor's
gradient within 1.9e-13 of its norm; at 64x160 with two source frames
and four blocks a branch: 6.6e-16, 1.9e-14, 3.3e-13). They
hold because the fuse
upsample's align-corners weights are the ones the JAX package computes
under jit (`ops/image.py`): its eagerly computed weights differ by up to
1e-6, which moved this step's terms by 3e-11 and its gradient norm by
9e-10.
"""

import pytest
import torch

import tripled_tpu.models.hrnet as jax_hrnet
import tripled_tpu_torch.models.hrnet as port_hrnet
from test_torch_port_variant_asca_steps import hold_variant_f64, variant_keys, variant_kwargs

torch.set_num_threads(1)



@pytest.fixture
def small_hrnet(monkeypatch):
    for module in (jax_hrnet, port_hrnet):
        monkeypatch.setattr(module, "_STAGE_MODULES", {2: 1, 3: 1, 4: 1})
        monkeypatch.setattr(module, "_BLOCKS_PER_BRANCH", 1)


def test_diffnet_step_float64_matches_jax(small_hrnet):
    kw = variant_kwargs(name="mono_baseline", disentangle_layers=(False,) * 5, use_diffnet=True)
    _, model = hold_variant_f64(kw, variant_keys(), erase=False)
    assert [len(stage) for stage in model.depth_encoder.stages] == [1, 1, 1]
    assert {len(b) for stage in model.depth_encoder.stages for m in stage
            for b in m.branches} == {1}
    assert type(model.depth_decoder).__name__ == "DIFFDepthDecoder"
