"""The port's colour conversions (`tripled_tpu_torch/ops/color.py`) against
the JAX package's (`tripled_tpu/ops/color.py`) on the CPU, NHWC.

Inputs are seeded: uniform RGB in [0, 1], and "knees": 0, 1, the sRGB
knee 0.04045 and its neighbours, greys whose linear value sits at the Lab
knee 0.008856, a black pixel (t = 0 under the cube-root clamp) and
colours whose Lab b drives lab2xyz's z below 0 (its clamp). Each
function's inputs are its inverse's outputs where it has one.

Tolerances, relative to the largest magnitude of the JAX output, and the
gaps seen:
- float32 values: 2e-6 (seen 5.9e-7 in xyz2lab, where a = 500 (tx - ty)
  amplifies a 1-ulp difference in t; 5.6e-7 in rgb2lab; 0 in rgb_to_gray
  and lab2xyz). The port's three-term dots take XLA's order (a product
  and two fused multiply-adds), so rgb_to_gray is bit-equal; the rest
  comes from `pow(t, 1/3)` against XLA's `cbrt` (1 ulp on 1.5% of
  uniform inputs) and from `pow(x, 2.4)` and `pow(x, 1/2.4)` in the two
  packages' maths libraries (1 ulp on 1.8%).
- float64 values: 1e-13 (seen 1.4e-15).
- Gradients through rgb2lab, rgb_to_l and rgb_to_gray: float32 2e-6 (seen
  3.3e-7, 1.8e-7 and 0), float64 1e-12 (seen 5.9e-16). All finite at 0
  and 1: the sRGB branch's unselected power and the clamped cube root's
  steep slope near 1e-12 are multiplied by zero, not by inf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.ops import color as jc
from tripled_tpu_torch.ops import color as tc

torch.set_num_threads(1)

VALUE_TOL = {np.float32: 2e-6, np.float64: 1e-13}
GRAD_TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _rgb(kind, dtype):
    rng = np.random.RandomState(7)
    x = rng.rand(2, 12, 20, 3)
    if kind == "knees":
        knee = 0.04045
        grey_at_lab_knee = ((0.008856 ** (1 / 2.4)) * 1.055) - 0.055  # sRGB of linear 0.008856
        special = [0.0, 1.0, knee, np.nextafter(knee, 0), np.nextafter(knee, 1),
                   0.0031308, 1e-7, grey_at_lab_knee, np.nextafter(grey_at_lab_knee, 1),
                   np.nextafter(grey_at_lab_knee, 0)]
        flat = x.reshape(-1, 3)
        for i, v in enumerate(special):
            flat[i] = v                                  # greys
            flat[len(special) + i] = [v, 1.0 - v, v]     # and colours
        flat[2 * len(special)] = [0.0, 0.0, 1.0]          # b << 0: z clamped in lab2xyz
        flat[2 * len(special) + 1] = [1.0, 1.0, 0.0]
    return x.astype(dtype)


def _inputs(name, kind, dtype):
    rgb = _rgb(kind, dtype)
    with jax.enable_x64(dtype == np.float64):
        xyz = jc.rgb2xyz(jnp.asarray(rgb))
        return {"rgb2xyz": rgb, "rgb2lab": rgb, "rgb_to_l": rgb, "rgb_to_gray": rgb,
                "xyz2rgb": np.asarray(xyz), "xyz2lab": np.asarray(xyz),
                "lab2xyz": np.asarray(jc.xyz2lab(xyz)),
                "lab2rgb": np.asarray(jc.rgb2lab(jnp.asarray(rgb)))}[name]


def _hold(got, want, dtype, rtol):
    """Within rtol[dtype] of the largest magnitude of `want`."""
    scale = np.abs(want).max()
    gap = np.abs(got - want).max() / scale
    assert gap <= rtol[dtype], gap


FUNCTIONS = ["rgb2xyz", "xyz2rgb", "xyz2lab", "lab2xyz", "rgb2lab", "lab2rgb", "rgb_to_l",
             "rgb_to_gray"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["uniform", "knees"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_values_match_jax(name, kind, dtype):
    x = _inputs(name, kind, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(getattr(jc, name)(jnp.asarray(x)))
    got = getattr(tc, name)(torch.from_numpy(x.copy()))
    assert got.dtype == torch.from_numpy(x).dtype
    assert got.shape == want.shape and np.isfinite(want).all()
    _hold(got.numpy(), want, dtype, VALUE_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("kind", ["uniform", "knees"])
@pytest.mark.parametrize("name", ["rgb2lab", "rgb_to_l", "rgb_to_gray"])
def test_gradients_match_jax(name, kind, dtype):
    x = _rgb(kind, dtype)
    with jax.enable_x64(dtype == np.float64):
        out_shape = getattr(jc, name)(jnp.asarray(x)).shape
        w = np.random.RandomState(3).rand(*out_shape).astype(dtype)
        want = np.asarray(jax.grad(lambda a: jnp.sum(getattr(jc, name)(a) * w))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    (getattr(tc, name)(tx) * torch.from_numpy(w)).sum().backward()
    got = tx.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    _hold(got, want, dtype, GRAD_TOL)


@pytest.mark.parametrize("kind", ["uniform", "knees"])
def test_lab_round_trip(kind):
    """lab2rgb(rgb2lab(x)) gives x back, in float64 to 1e-6 (the
    conversions' constants are rounded to six or so digits, and the Lab
    knee's two branches meet only to that precision)."""
    x = _rgb(kind, np.float64)
    back = tc.lab2rgb(tc.rgb2lab(torch.from_numpy(x))).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-6)


def test_ranges():
    """Normalised Lab of [0, 1] RGB: L in [-1, 1], ab within [-1, 1];
    rgb_to_l in [0, 1]; grey in [0, 1]."""
    x = torch.from_numpy(_rgb("knees", np.float64))
    lab = tc.rgb2lab(x)
    assert lab[..., 0].min() >= -1 - 1e-9 and lab[..., 0].max() <= 1 + 1e-6
    assert lab[..., 1:].abs().max() <= 1.0
    assert tc.rgb_to_l(x).min() >= 0 and tc.rgb_to_l(x).max() <= 1 + 1e-6
    assert tc.rgb_to_gray(x).min() >= 0 and tc.rgb_to_gray(x).max() <= 1 + 1e-12
