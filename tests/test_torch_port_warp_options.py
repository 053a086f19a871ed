"""The warp options of tripled_tpu_torch against the JAX package's, on the
CPU, with no JAX training step: the block warp (`ops/warp.grid_sample_block`)
against `tripled_tpu.ops.warp.grid_sample_block`, the bf16 texels
(`gather_dtype`) on the exact and the block warp, and the model's
`_grid_sample`, through which every warp goes (`warp_align_corners=False`,
the texel dtype, the block warp's channel gate and its divisibility
fallback), against the JAX TripleDNet's; and `warp_block_shape`'s check.

Float64: values and the gradients of sum(out * a fixed random tensor) into
the image and into the coordinates within 1e-9 of the largest magnitude
(the two compute the same interpolation in another order: about 1e-15).
With bf16 texels the image gradient is held within TOL_BF16_IMAGE_GRAD =
2e-2 of its largest magnitude: the JAX backward rounds each texel's
cotangent to bf16 and sums a texel's cotangents in bf16 (the gather's
scatter-add and the patch planes' shifts), the port sums them in the
image's dtype and rounds the sum once (the cast's backward); a texel
collects up to about 8 cotangents here, each rounding within 2^-9 (seen
4.6e-3). Values and the coordinate gradient read the rounded texels
alike and stay within 1e-9.
Float32 values within 1e-5: F.grid_sample normalises the pixel coordinates
to [-1, 1] and back (`ops/warp.grid_sample`), which moves a coordinate of
up to 100 px by a few float32 ulps, times an image gradient of up to 1 a
pixel; seen 1.6e-6.

The flows: smooth (every sample inside its block's patch, so the block
warp is the exact warp), wild (a random shift of 2.5 px standard
deviation per pixel: over 10% of the samples clamp to the patch's edge,
asserted, so a block warp that took the exact path would show), and out
of bounds (coordinates from -4 px to 4 px past the far border).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models.registry import build_model
from tripled_tpu.ops import warp as jax_warp
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops import warp as port_warp

torch.set_num_threads(1)

TOL_F64 = 1e-9
TOL_F32 = 1e-5
TOL_BF16_IMAGE_GRAD = 2e-2
B, H, W = 2, 12, 16


def flow(kind, b, h, w, seed=0):
    """Pixel coordinates (b, h, w, 2) of the kind named (module docstring)."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float64), np.arange(w, dtype=np.float64),
                         indexing="ij")
    if kind == "smooth":
        phase = rng.rand(b, 1, 1, 2) * 6.28
        dx = 1.2 * np.sin(xs / 7.0 + phase[..., 0]) + rng.randn(b, 1, 1) * 0.3
        dy = 1.2 * np.cos(ys / 9.0 + phase[..., 1]) + rng.randn(b, 1, 1) * 0.3
        return np.stack([xs + dx, ys + dy], -1)
    if kind == "wild":
        return np.stack([xs + rng.randn(b, h, w) * 2.5, ys + rng.randn(b, h, w) * 2.5], -1) - 0.5
    assert kind == "out_of_bounds"
    sx, sy = (w + 8.0) / (w - 1.0), (h + 8.0) / (h - 1.0)
    return np.broadcast_to(np.stack([xs * sx - 4.0, ys * sy - 4.0], -1),
                           (b, h, w, 2)) + rng.randn(b, h, w, 2) * 0.1


def _close(got, want, tol, what=""):
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max()
    assert err <= tol * scale, (what, err, scale)


def hold(jax_fn, port_fn, img, coords, seed=0, image_grad_tol=TOL_F64):
    """Values and gradients (into img and coords) of jax_fn and port_fn,
    (img, coords) -> (B, Ho, Wo, C), in float64; returns the JAX values."""
    gout = np.random.RandomState(seed + 7).randn(*coords.shape[:3], img.shape[-1])

    def value_and_grads(i, c, g):
        out, vjp = jax.vjp(jax_fn, i, c)
        return (out, *vjp(g))

    with jax.enable_x64(True):
        want, gimg, gcoords = jax.jit(value_and_grads)(img, coords, gout)
        want = np.asarray(want)
    ti = torch.tensor(img, requires_grad=True)
    tc = torch.tensor(coords, requires_grad=True)
    got = port_fn(ti, tc)
    (got * torch.from_numpy(gout)).sum().backward()
    _close(got.detach().numpy(), want, TOL_F64, "values")
    _close(ti.grad.numpy(), np.asarray(gimg), image_grad_tol, "image gradient")
    # the nearest warp's coordinates get no gradient (zero in JAX)
    tgrad = tc.grad if tc.grad is not None else torch.zeros_like(tc)
    _close(tgrad.numpy(), np.asarray(gcoords), TOL_F64, "coordinate gradient")
    return want


def clamped_share(img, coords, block):
    """The share of output pixels where the JAX block warp leaves the exact
    warp (float64)."""
    with jax.enable_x64(True):
        exact, blocked = jax.jit(lambda i, c: (jax_warp.grid_sample(i, c),
                                               jax_warp.grid_sample_block(i, c, block=block)))(
            img, coords)
        exact, blocked = np.asarray(exact), np.asarray(blocked)
    return float((np.abs(exact - blocked).max(-1) > 1e-12).mean())


# ------------------------------------------------------------ block warp


@pytest.mark.parametrize("kind", ["smooth", "wild", "out_of_bounds"])
@pytest.mark.parametrize("c", [3, 64])
@pytest.mark.parametrize("block", [(2, 2), (2, 4)])
def test_block_warp_matches_jax(block, c, kind):
    rng = np.random.RandomState(c)
    img = rng.rand(B, H, W, c)
    coords = flow(kind, B, H, W, seed=c + block[1])
    hold(lambda i, cc: jax_warp.grid_sample_block(i, cc, block=block),
         lambda i, cc: port_warp.grid_sample_block(i, cc, block=block), img, coords)
    share = clamped_share(img, coords, block)
    if kind == "wild":
        assert share > 0.1, share
    elif kind == "smooth":
        assert share == 0.0
    # float32
    want = np.asarray(jax.jit(lambda i, cc: jax_warp.grid_sample_block(i, cc, block=block))(
        img.astype(np.float32), coords.astype(np.float32)))
    got = port_warp.grid_sample_block(torch.tensor(img, dtype=torch.float32),
                                      torch.tensor(coords, dtype=torch.float32), block=block)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, TOL_F32)


def test_block_warp_cap_falls_back_to_2x2_as_jax(monkeypatch):
    """A (2, 4) block whose 72 patch lanes would pad to 128 over the byte
    cap falls back to (2, 2) in both packages; under the default cap it
    does not (on wild flow the two blocks differ)."""
    rng = np.random.RandomState(3)
    img = rng.rand(B, H, W, 3)
    coords = flow("wild", B, H, W, seed=4)
    two_by_two = hold(lambda i, cc: jax_warp.grid_sample_block(i, cc, block=(2, 2)),
                      lambda i, cc: port_warp.grid_sample_block(i, cc, block=(2, 2)), img, coords)
    default = hold(lambda i, cc: jax_warp.grid_sample_block(i, cc, block=(2, 4)),
                   lambda i, cc: port_warp.grid_sample_block(i, cc, block=(2, 4)), img, coords)
    assert np.abs(default - two_by_two).max() > 1e-3
    # 2*12*16*128*8 bytes = 393216: over a cap of 393215, not over 393216
    monkeypatch.setenv("TRIPLED_WARP_PAD64_CAP", "393215")
    capped = hold(lambda i, cc: jax_warp.grid_sample_block(i, cc, block=(2, 4)),
                  lambda i, cc: port_warp.grid_sample_block(i, cc, block=(2, 4)), img, coords)
    np.testing.assert_array_equal(capped, two_by_two)
    monkeypatch.setenv("TRIPLED_WARP_PAD64_CAP", "393216")
    at_cap = port_warp.grid_sample_block(torch.tensor(img), torch.tensor(coords), block=(2, 4))
    _close(at_cap.numpy(), default, TOL_F64)


# ------------------------------------------------------------ bf16 texels


@pytest.mark.parametrize("path", ["exact", "block_2x2", "block_2x4"])
def test_bf16_texels_match_jax(path):
    """The texels rounded to bf16, the interpolation in the image's dtype:
    float64 values and coordinate gradients within 1e-9, the image
    gradient within TOL_BF16_IMAGE_GRAD, float32 values within TOL_F32.
    The rounding moves the values by up to 2^-9 of a texel, far above the
    value tolerances."""
    rng = np.random.RandomState(11)
    img = rng.rand(B, H, W, 3)
    coords = flow("wild", B, H, W, seed=12)
    if path == "exact":
        jfn = lambda i, cc: jax_warp.grid_sample(i, cc, gather_dtype=jnp.bfloat16)  # noqa: E731
        pfn = lambda i, cc: port_warp.grid_sample(i, cc, gather_dtype=torch.bfloat16)  # noqa: E731
    else:
        block = (2, 2) if path == "block_2x2" else (2, 4)
        jfn = lambda i, cc: jax_warp.grid_sample_block(  # noqa: E731
            i, cc, gather_dtype=jnp.bfloat16, block=block)
        pfn = lambda i, cc: port_warp.grid_sample_block(  # noqa: E731
            i, cc, gather_dtype=torch.bfloat16, block=block)
    want = hold(jfn, pfn, img, coords, image_grad_tol=TOL_BF16_IMAGE_GRAD)
    unrounded = (port_warp.grid_sample(torch.tensor(img), torch.tensor(coords)) if path == "exact"
                 else port_warp.grid_sample_block(torch.tensor(img), torch.tensor(coords),
                                                  block=block))
    assert np.abs(unrounded.numpy() - want).max() > 1e-4
    want32 = np.asarray(jax.jit(jfn)(img.astype(np.float32), coords.astype(np.float32)))
    got32 = pfn(torch.tensor(img, dtype=torch.float32), torch.tensor(coords, dtype=torch.float32))
    assert got32.dtype == torch.float32
    _close(got32.numpy(), want32, TOL_F32)


# ------------------------------------------------------- the net's warp

BASE = dict(name="mono_baseline", depth_num_layers=18, pose_num_layers=18, height=24, width=32)
# (options, channels, (h, w) of the image, method): the output has the
# image's size, so the (2, 4) cases with width 30 fail the divisibility test
GRID_CASES = {
    "align_false_color": (dict(warp_align_corners=False), 3, (24, 32), "bilinear"),
    "align_false_half": (dict(warp_align_corners=False), 64, (12, 16), "bilinear"),
    "align_false_nearest": (dict(warp_align_corners=False), 1, (24, 32), "nearest"),
    "bf16_texels": (dict(warp_gather_dtype="bfloat16"), 3, (24, 32), "bilinear"),
    "block_2x2_color": (dict(warp_block_gather=True), 3, (24, 32), "bilinear"),
    "block_2x4_color": (dict(warp_block_gather=True, warp_block_shape=(2, 4)), 3, (24, 32),
                        "bilinear"),
    "block_2x4_indivisible": (dict(warp_block_gather=True, warp_block_shape=(2, 4)), 3,
                              (24, 30), "bilinear"),
    "block_features_off": (dict(warp_block_gather=True), 64, (12, 16), "bilinear"),
    "block_features_2x2": (dict(warp_block_gather=True, warp_block_features=True,
                                warp_block_shape=(2, 4)), 64, (12, 16), "bilinear"),
    "block_nearest_exact": (dict(warp_block_gather=True), 1, (24, 32), "nearest"),
    "every_option_half": (dict(warp_align_corners=False, warp_gather_dtype="bfloat16",
                               warp_block_gather=True, warp_block_features=True),
                          64, (12, 16), "bilinear"),
    "every_option_color": (dict(warp_align_corners=False, warp_gather_dtype="bfloat16",
                                warp_block_gather=True, warp_block_shape=(2, 4)),
                           3, (24, 32), "bilinear"),
}


def _port_grid_sample(options):
    """`TripleDNet._grid_sample` reads nothing but the config: bound here to
    a stand-in that holds one (building the networks takes seconds)."""
    holder = types.SimpleNamespace(cfg=ModelConfig(**BASE, **options))
    return lambda img, coords, method="bilinear": TripleDNet._grid_sample(
        holder, img, coords, method)


def _jax_grid_sample(options, method):
    jmodel = build_model(JaxModelConfig(**BASE, **options))
    return lambda i, c: jmodel.apply({}, i, c, method=lambda m, a, b: m._grid_sample(a, b, method))


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_net_grid_sample_matches_jax(name):
    """`TripleDNet._grid_sample` against the JAX TripleDNet's on wild flow,
    in float64 (values and gradients; the nearest warp's coordinate
    gradient is 0 in both); the block cases must leave the exact warp and
    the exact cases must not."""
    options, c, (h, w), method = GRID_CASES[name]
    rng = np.random.RandomState(sorted(GRID_CASES).index(name))
    img = rng.rand(B, h, w, c)
    if method == "nearest":
        img = (img > 0.5).astype(np.float64)  # a mask
    coords = flow("wild", B, h, w, seed=5)
    port = _port_grid_sample(options)
    bf16 = options.get("warp_gather_dtype") == "bfloat16" and method == "bilinear"
    want = hold(_jax_grid_sample(options, method),
                lambda i, cc: port(i, cc, method), img, coords,
                image_grad_tol=TOL_BF16_IMAGE_GRAD if bf16 else TOL_F64)
    exact = _jax_grid_sample({k: v for k, v in options.items() if not k.startswith("warp_block")},
                             method)
    with jax.enable_x64(True):
        exact = np.asarray(jax.jit(exact)(img, coords))
    blocked = name in ("block_2x2_color", "block_2x4_color", "block_features_2x2",
                       "every_option_half", "every_option_color")
    assert (np.abs(want - exact).max() > 1e-3) == blocked


def test_align_corners_false_uses_the_sampled_images_size():
    """x * w/(w-1) - 0.5 with w the sampled image's width: at the image's
    size and at its half the same coordinates move differently."""
    port = _port_grid_sample(dict(warp_align_corners=False))
    coords = torch.tensor([[[[3.0, 2.0]]]], dtype=torch.float64)
    for h, w in [(24, 32), (12, 16)]:
        img = torch.arange(h * w, dtype=torch.float64).reshape(1, h, w, 1)
        x, y = 3.0 * w / (w - 1) - 0.5, 2.0 * h / (h - 1) - 0.5
        want = port_warp.grid_sample(img, torch.tensor([[[[x, y]]]], dtype=torch.float64))
        torch.testing.assert_close(port(img, coords), want, rtol=0, atol=0)


# ------------------------------------------------------ warp_block_shape


@pytest.mark.parametrize("value", [[2, 4], (2, 4), [1, 1]])
def test_warp_block_shape_list_becomes_a_tuple(value):
    assert ModelConfig(warp_block_shape=value).warp_block_shape == tuple(value)
    assert JaxModelConfig(warp_block_shape=value).warp_block_shape == tuple(value)


@pytest.mark.parametrize("value", [(2,), (2, 2, 2), (0, 2), (2, -1), (2.0, 2), ("2", "2")])
def test_warp_block_shape_refused_as_jax(value):
    with pytest.raises(ValueError) as want:
        JaxModelConfig(warp_block_shape=value)
    with pytest.raises(ValueError) as got:
        ModelConfig(warp_block_shape=value)
    assert str(got.value) == str(want.value)
    assert "warp_block_shape must be two positive ints" in str(got.value)


def test_replace_keeps_the_block_shape_check():
    """dataclasses.replace keeps the check: a replaced list is a tuple."""
    cfg = dataclasses.replace(ModelConfig(), warp_block_shape=[2, 4])
    assert cfg.warp_block_shape == (2, 4)
