"""tripled_tpu_torch ops against the JAX package's: values and gradients on
the same numpy inputs, on the CPU. Tolerances are float32 rounding of
differently ordered sums unless a case says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.ops import geometry as jgeo
from tripled_tpu.ops import image as jimg
from tripled_tpu.ops import losses as jloss
from tripled_tpu.ops.ssim import ssim as jax_ssim
from tripled_tpu.ops import warp as jwarp
from tripled_tpu_torch.ops import geometry as tgeo
from tripled_tpu_torch.ops import image as timg
from tripled_tpu_torch.ops import losses as tloss
from tripled_tpu_torch.ops.ssim import ssim as torch_ssim
from tripled_tpu_torch.ops import warp as twarp

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(torch_val, jax_val, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(torch_val.detach().numpy(), np.asarray(jax_val), rtol=rtol, atol=atol)


def _grads_match(jfn, tfn, args, rtol=1e-4, atol=1e-6):
    """Value and gradient of sum(f * w) for a fixed random weight w."""
    out = jfn(*args)
    w = np.random.RandomState(7).rand(*out.shape).astype(np.float32)
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * w), argnums=tuple(range(len(args))))(*args)
    targs = [_t(a, grad=True) for a in args]
    tout = tfn(*targs)
    _close(tout, out, rtol=1e-5, atol=1e-6)
    (tout * torch.from_numpy(w)).sum().backward()
    for ta, ga in zip(targs, jg):
        _close(ta.grad, ga, rtol=rtol, atol=atol)


def _camera(rng, b, h, w):
    K = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    K[:, 0, 0] = 0.58 * w * (1 + 0.1 * rng.rand(b))
    K[:, 1, 1] = 1.92 * h
    K[:, 0, 2] = 0.5 * w
    K[:, 1, 2] = 0.5 * h
    return K


def test_pose_geometry(rng_np):
    aa = (rng_np.randn(3, 1, 3) * 0.1).astype(np.float32)
    tr = (rng_np.randn(3, 1, 3) * 0.1).astype(np.float32)
    for invert in (False, True):
        _grads_match(
            lambda a, t: jgeo.transformation_from_parameters(a, t, invert=invert),
            lambda a, t: tgeo.transformation_from_parameters(a, t, invert=invert),
            (aa, tr))
    _grads_match(jgeo.rot_from_axisangle, tgeo.rot_from_axisangle, (aa,))
    K = _camera(rng_np, 3, 16, 24)
    _close(tgeo.invert_intrinsics(_t(K)), jgeo.invert_intrinsics(K))
    _close(tgeo.invert_intrinsics(_t(K)), np.linalg.inv(K), rtol=1e-5, atol=1e-6)
    _close(tgeo.scale_intrinsics(_t(K), 0.5, 0.25), jgeo.scale_intrinsics(K, 0.5, 0.25))


def test_projection(rng_np):
    b, h, w = 2, 12, 20
    depth = (rng_np.rand(b, h, w, 1) * 10 + 1).astype(np.float32)
    K = _camera(rng_np, b, h, w)
    inv_K = np.linalg.inv(K).astype(np.float32)
    T = np.asarray(jgeo.transformation_from_parameters(
        rng_np.randn(b, 1, 3).astype(np.float32) * 0.05,
        rng_np.randn(b, 1, 3).astype(np.float32) * 0.1))
    pts = jgeo.backproject(depth, inv_K)
    _close(tgeo.backproject(_t(depth), _t(inv_K)), pts, rtol=1e-5, atol=1e-5)
    for normalized in (False, True):
        _close(tgeo.project(_t(np.asarray(pts)), _t(K), _t(T), h, w, normalized=normalized),
               jgeo.project(pts, K, T, h, w, normalized=normalized), rtol=1e-5, atol=1e-4)
    _grads_match(lambda d, t: jgeo.warp_coords(d, inv_K, K, t),
                 lambda d, t: tgeo.warp_coords(d, _t(inv_K), _t(K), t),
                 (depth, T), rtol=1e-4, atol=1e-4)
    _grads_match(lambda d: jgeo.disp_to_depth(d, 0.1, 100.0)[1],
                 lambda d: tgeo.disp_to_depth(d, 0.1, 100.0)[1],
                 (rng_np.rand(b, h, w, 1).astype(np.float32),))


@pytest.mark.parametrize("size", [(24, 40), (6, 10), (5, 7), (17, 29)])
def test_resize_bilinear(size, rng_np):
    x = rng_np.rand(2, 12, 20, 3).astype(np.float32)
    _grads_match(lambda a: jimg.resize_bilinear(a, *size),
                 lambda a: timg.resize_bilinear(a, *size), (x,))


def test_resize_area_and_upsample(rng_np):
    x = rng_np.rand(2, 12, 20, 3).astype(np.float32)
    _close(timg.resize_area(_t(x), 3, 5), jimg.resize_area(x, 3, 5))
    nchw = np.transpose(x, (0, 3, 1, 2))
    _close(timg.upsample2x_nearest(_t(nchw)),
           np.transpose(np.asarray(jimg.upsample2x_nearest(x)), (0, 3, 1, 2)))
    # a non-integer factor: the JAX package's antialiased linear resize
    _close(timg.resize_area(_t(x), 5, 5), jimg.resize_area(x, 5, 5))


def test_ssim_and_reprojection(rng_np):
    x = rng_np.rand(2, 10, 14, 3).astype(np.float32)
    y = rng_np.rand(2, 10, 14, 3).astype(np.float32)
    _grads_match(jax_ssim, torch_ssim, (x, y))
    _grads_match(jloss.reprojection_loss, tloss.reprojection_loss, (x, y))
    _grads_match(jloss.robust_l1, tloss.robust_l1, (x, y))
    _grads_match(jloss.perceptional_loss, tloss.perceptional_loss, (x, y))


def test_min_reprojection_with_automask(rng_np):
    preds = [rng_np.rand(2, 6, 8, 1).astype(np.float32) for _ in range(2)]
    idents = [rng_np.rand(2, 6, 8, 1).astype(np.float32) for _ in range(2)]
    # the JAX package draws its tie-break noise itself; hand the port the
    # same numbers
    key = jax.random.PRNGKey(3)
    ident = jnp.concatenate(idents, -1)
    noise = np.asarray(jax.random.normal(key, ident.shape, ident.dtype) * 1e-5)
    ref = jloss.min_reprojection_with_automask(preds, idents, key)
    _close(tloss.min_reprojection_with_automask([_t(p) for p in preds], [_t(i) for i in idents],
                                                 _t(noise)), ref, rtol=0, atol=1e-7)
    _close(tloss.min_reprojection_with_automask([_t(p) for p in preds], []),
           jloss.min_reprojection_with_automask(preds, [], None), rtol=0, atol=0)


@pytest.mark.parametrize("hw", [(8, 16), (2, 9)])
def test_smooth_loss(hw, rng_np):
    h, w = hw
    disp = rng_np.rand(2, h, w, 1).astype(np.float32)
    img = rng_np.rand(2, 2 * h, 2 * w, 3).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda d: jloss.smooth_loss(d, img))(disp)
    td = _t(disp, grad=True)
    tv = tloss.smooth_loss(td, _t(img))
    tv.backward()
    _close(tv, jv, rtol=1e-5, atol=0)
    _close(td.grad, jg, rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("c", [3, 64])
def test_grid_sample(c, rng_np):
    b, h, w = 2, 9, 13
    img = rng_np.rand(b, h, w, c).astype(np.float32)
    # inside, outside (border clamp) and exactly on the last row / column
    coords = np.stack([rng_np.uniform(-3, w + 2, (b, 7, 11)),
                       rng_np.uniform(-3, h + 2, (b, 7, 11))], -1).astype(np.float32)
    coords[:, 0, :, 0] = w - 1.0
    coords[:, 1, :, 1] = h - 1.0
    _grads_match(jwarp.grid_sample, twarp.grid_sample, (img, coords), rtol=1e-4, atol=1e-5)
