"""`load_jax_variables` for every architecture option, with the JAX
package's `remat` on and off, and the eval-mode disparities of the two HR
models against the JAX package's, on the CPU.

The loads: each option's JAX variable tree (read off the JAX model itself,
`jax.eval_shape` of its init, filled from a numpy seed) goes into the
port's model of the same config; every key must be consumed and every
tensor written (`load_jax_variables` raises otherwise). Here with remat on
(the `asca` model carries the 1x1 split, the 1x1 colour skips, pose from
prediction and the shuffle decoder too; `pa`'s tree is `ca`'s; DIFFNet's
holds the full HRNet-18), and off for pose from prediction without
auto_res; the other remat-off trees load in the variant step files and
in the eval test.

The eval disparities: HR-Depth on R18 and DIFFNet on HRNet-18 with one
module per stage (as `test_torch_port_variant_hrnet.py` cuts it), at
64x96, float64, BatchNorm on running statistics, within 1e-9 of the
largest disparity; and the port's `make_predict_fn` on each, whose scale
0 is at the input's full size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tripled_tpu.models.hrnet as jax_hrnet
import tripled_tpu_torch.models.hrnet as port_hrnet
from test_torch_port_step import _port_model, _random_variables, make_inputs
from test_torch_port_variant_asca_steps import H, W, variant_kwargs
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models.registry import build_model
from tripled_tpu_torch.train.step import make_predict_fn

torch.set_num_threads(1)

HR = variant_kwargs(name="mono_baseline", disentangle_layers=(False,) * 5)
OPTIONS = {
    "asca_1x1_color_pfp_shuffle": variant_kwargs(
        depth_skip_type="asca", depth_disentangle_type="1x1", color_skip_type="1x1",
        color_skip_layers=(False, True, False, True), use_pfp=True, depth_use_shuffle=True,
        auto_res_weight=5e-3),
    "ca": variant_kwargs(depth_skip_type="ca"),
    "1x1_full_last_stage": variant_kwargs(depth_skip_type="1x1",
                                          disentangle_layers=(False, False, False, True, False)),
    "pfp_without_auto_res": variant_kwargs(use_pfp=True),
    "hr_depth": dict(HR, use_hr_depth=True),
    "diffnet": dict(HR, use_diffnet=True),
}


def _inputs(kwargs, dtype=np.float32):
    mask = np.ones((2, H, W, 1)) if "disentangle" in kwargs["name"] else None
    inputs = make_inputs(dtype, H, W, mask=mask)
    for key in ("color", "color_aug"):
        inputs[key] = inputs[key][:, :2]
    return inputs


@pytest.mark.parametrize("name,remat", [(name, True) for name in sorted(OPTIONS)]
                         + [("pfp_without_auto_res", False)])
def test_every_option_tree_loads(name, remat):
    kwargs = dict(OPTIONS[name], remat=remat)
    params, stats = _random_variables(build_model(JaxModelConfig(**kwargs)), _inputs(kwargs))
    model = _port_model(kwargs, torch.float32, params, stats)
    if name == "pfp_without_auto_res":  # the colour decoder exists for the pose net alone
        assert hasattr(model, "color_decoder")


@pytest.mark.parametrize("name", ["hr_depth", "diffnet"])
def test_hr_model_eval_disparities_match_jax(name, monkeypatch):
    for module in (jax_hrnet, port_hrnet):
        monkeypatch.setattr(module, "_STAGE_MODULES", {2: 1, 3: 1, 4: 1})
    kwargs = OPTIONS[name]
    with jax.enable_x64(True):
        inputs = _inputs(kwargs, np.float64)
        jmodel = build_model(JaxModelConfig(**kwargs))
        params, stats = _random_variables(jmodel, inputs, np.float64)
        image = {"color_aug": jnp.asarray(inputs["color_aug"][:, :1]),
                 "color": jnp.asarray(inputs["color"][:, :1])}
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, image)
        want = [np.asarray(d) for d in want]
    model = _port_model(kwargs, torch.float64, params, stats).eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v)) for k, v in image.items()})
    assert [d.shape[1:3] for d in want] == [(H, W), (H // 2, W // 2), (H // 4, W // 4),
                                            (H // 8, W // 8)]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-9 * np.abs(w).max()
    scaled = make_predict_fn(model)(torch.from_numpy(inputs["color"][:, :1]))
    assert tuple(scaled.shape) == (2, H, W, 1) and torch.isfinite(scaled).all()
