"""HRNet (`models/hrnet.py`), DIFFNet's encoder, against the JAX package's
`HRNetFeatures` on the CPU in float64, at width 18 on a 64x96 image,
batch 2, in training mode: all eleven nested outputs, the gradients of a
scalar of them with respect to the image and every parameter, and the
BatchNorm running statistics after the forward, each within
`test_torch_port_variant_modules.TOL` (1e-9).

Every layer and path of HRNet-18 is here, but one module per stage (1/1/1
for 1/4/3; `_STAGE_MODULES`, patched in both packages): the JAX compile of
the full network's forward and gradient takes two minutes of the CPU
test budget. The full network's tree is held by the weight loads of
`test_torch_port_variant_weights.py`, and the full network on the card
against the CPU by `chip_smoke.py`'s reference_variants and
`tests/test_torch_port_cuda.py`. The fuse upsample's align-corners weights are
the JAX package's under jit (`ops/image.py`); an eager JAX forward
computes others, up to 1e-6 apart.
"""

import numpy as np
import pytest
import torch

import tripled_tpu.models.hrnet as jax_hrnet
import tripled_tpu_torch.models.hrnet as port_hrnet
from test_torch_port_variant_modules import compare

torch.set_num_threads(1)


@pytest.fixture
def one_module_per_stage(monkeypatch):
    for module in (jax_hrnet, port_hrnet):
        monkeypatch.setattr(module, "_STAGE_MODULES", {2: 1, 3: 1, 4: 1})


def test_hrnet18_train_forward_gradients_and_statistics_match_jax(one_module_per_stage):
    x = np.random.RandomState(21).rand(2, 64, 96, 3)
    outs = compare(jax_hrnet.HRNetFeatures(18), (x,), port_hrnet.HRNetFeatures(18),
                   lambda loader, m: loader.hrnet(m, ()), train=True, seed=2)
    shapes = [o.shape[1:] for o in outs]
    assert shapes == [(32, 48, 64), (16, 24, 64)] + [(16, 24, 18)] * 3 + [(8, 12, 36)] * 3 + [
        (4, 6, 72)] * 2 + [(2, 3, 144)]
