"""The eq-mask CRP pool of tripled_tpu_torch (`models/layers.py`
`max_pool_5x5_same_eqmask`, `ModelConfig.pool_eqmask_grad`) against the
JAX package's (`tripled_tpu/models/layers.py:143-207`), on the CPU; and
`load_jax_variables` for a model with every warp and kernel option on.

The pool: the forward equal bit for bit to JAX's; the backward against
`jax.vjp` of the JAX function in float64 within 1e-12 of the cotangent's
largest magnitude (each position sums at most 25 quotients g / ties in
the JAX order, di then dj: the same float operations), on tie-free input,
on plateaus with ties, at the borders (a 3x4 image: every window is cut),
and on negative values. `CRPBlock` with the flag against the JAX
`CRPBlock` with carried weights, on a plateau input, through
`test_torch_port_variant_modules.compare` (TOL 1e-9 of the largest
magnitude).

The tree: none of the options adds a parameter; a JAX tree built with
every option on (mono_fm with its R18 extractor, frame ids (0, -1, "s"))
loads into the port's model built the same way, every key consumed, and
the float64 eval disparities agree within 1e-9 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_step import _port_model, _random_variables, make_inputs
from test_torch_port_variant_modules import compare
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models import layers as jl
from tripled_tpu.models.registry import build_model
from tripled_tpu_torch.models import layers as tl

torch.set_num_threads(1)

C = 8


def pool_input(kind, seed=0):
    """(2, h, w, C) float64 NHWC of the kind named (module docstring)."""
    rng = np.random.RandomState(seed)
    if kind == "tie_free":
        return rng.standard_normal((2, 10, 14, C))
    if kind == "plateaus":  # four levels: most windows tie at their max
        return np.floor(rng.rand(2, 10, 14, C) * 4) / 4
    if kind == "borders":
        return np.floor(rng.rand(2, 3, 4, C) * 3) / 3
    assert kind == "negative"
    return -1.0 - np.floor(rng.rand(2, 10, 14, C) * 3)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("kind", ["tie_free", "plateaus", "borders", "negative"])
def test_eqmask_pool_matches_jax(kind):
    x = pool_input(kind)
    g = np.random.RandomState(1).standard_normal(x.shape)
    with jax.enable_x64(True):
        y, vjp = jax.vjp(jl.max_pool_5x5_same_eqmask, jnp.asarray(x))
        (gx,) = vjp(jnp.asarray(g))
        y, gx = np.asarray(y), np.asarray(gx)
    tx = _nchw(x).requires_grad_()
    ty = tl.max_pool_5x5_same_eqmask(tx)
    (ty * _nchw(g)).sum().backward()
    np.testing.assert_array_equal(_nhwc(ty), y)
    assert np.abs(_nhwc(tx.grad) - gx).max() <= 1e-12 * np.abs(g).max()
    # the gradient's mass is the cotangent's: every window hands all of its
    # gradient to its tied positions
    np.testing.assert_allclose(tx.grad.sum().item(), g.sum(), rtol=1e-12)
    # float32: the forward bit for bit
    with jax.enable_x64(False):
        y32 = np.asarray(jl.max_pool_5x5_same_eqmask(jnp.asarray(x, jnp.float32)))
    np.testing.assert_array_equal(_nhwc(tl.max_pool_5x5_same_eqmask(_nchw(x).float())), y32)


@pytest.mark.parametrize("kind", ["tie_free", "plateaus"])
def test_eqmask_pool_against_the_max_pool_backward(kind):
    """Without ties the eq-mask backward is F.max_pool2d's (one position a
    window, the same sums in another order); with ties it spreads a window's
    gradient over its tied positions where F.max_pool2d gives it to one."""
    x = _nchw(pool_input(kind, seed=2))
    g = _nchw(np.random.RandomState(3).standard_normal(x.permute(0, 2, 3, 1).shape))
    grads = []
    for pool in (tl.max_pool_5x5_same_eqmask, tl.max_pool_5x5_same):
        xi = x.clone().requires_grad_()
        (pool(xi) * g).sum().backward()
        grads.append(xi.grad)
    gap = (grads[0] - grads[1]).abs().max().item()
    if kind == "tie_free":
        assert gap <= 1e-13 * g.abs().max().item()
    else:
        assert gap > 1e-2
        assert (grads[0] != 0).sum() > (grads[1] != 0).sum()


def test_crp_block_with_eqmask_matches_jax():
    def load(loader, m):
        for j, conv in enumerate(m.convs):
            loader.conv(conv, (f"Conv1x1_{j}", "Conv_0"))

    compare(jl.CRPBlock(C, 4, eqmask_pool=True), (pool_input("plateaus", seed=4),),
            tl.CRPBlock(C, 4, eqmask_pool=True), load, seed=5)


def test_decoder_takes_the_flag():
    from tripled_tpu_torch.config import ModelConfig
    from tripled_tpu_torch.models.net import TripleDNet

    for flag, pool in [(False, tl.max_pool_5x5_same), (True, tl.max_pool_5x5_same_eqmask)]:
        model = TripleDNet(ModelConfig(name="mono_baseline", depth_num_layers=18, height=64,
                                       width=96, pool_eqmask_grad=flag))
        assert all(level.crp.pool is pool for level in model.depth_decoder.levels)


# ------------------------------------------------------------ the tree

H, W = 64, 96
EVERY_OPTION = dict(
    name="mono_fm", depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18,
    height=H, width=W, pose_height=H, pose_width=W, depth_dropout_rate=0.0,
    frame_ids=(0, -1, "s"), automask=False, disp_norm=False, warp_align_corners=False,
    warp_gather_dtype="bfloat16", warp_block_gather=True, warp_block_shape=(2, 4),
    warp_block_features=True, use_pallas_photometric=False, pool_eqmask_grad=True)


def test_every_option_tree_loads_and_eval_matches_jax():
    with jax.enable_x64(True):
        inputs = make_inputs(np.float64, H, W)
        inputs["stereo_T"] = np.tile(np.eye(4), (2, 1, 1))
        inputs["stereo_T"][:, 0, 3] = 0.015
        jmodel = build_model(JaxModelConfig(**EVERY_OPTION))
        params, stats = _random_variables(jmodel, inputs, np.float64)
        plain = build_model(JaxModelConfig(**{k: v for k, v in EVERY_OPTION.items()
                                              if not k.startswith(("warp", "use_pallas",
                                                                   "pool", "frame"))}))
        plain_params, _ = _random_variables(plain, make_inputs(np.float64, H, W), np.float64)
        # no option adds or removes a parameter
        assert (jax.tree_util.tree_structure(params)
                == jax.tree_util.tree_structure(plain_params))
        image = {k: jnp.asarray(inputs[k][:, :1]) for k in ("color", "color_aug")}
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
            {"params": params, "batch_stats": stats}, image)
        want = [np.asarray(d) for d in want]
    model = _port_model(EVERY_OPTION, torch.float64, params, stats).eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(np.asarray(v)) for k, v in image.items()})
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-9 * np.abs(w).max()
