"""The port's device ColorJitter (`tripled_tpu_torch/ops/jitter.py`) against
the JAX package's (`tripled_tpu/ops/jitter.py`) on the CPU, from seeded
numpy inputs: all 24 op orders, apply at 0 and 1, factors drawn from
the ColorJitter's ranges, at both ends of them and beyond them, frames
with black, white, grey and tied pixels.

Tolerance 2e-6 with the factors in their ranges, the JAX package's own
bound for its device jitter against the host jitter (`tests/test_data.py`).
The contrast mean is a float32 sum that the two libraries take in other
orders, and XLA fuses multiply-adds the port rounds twice; the hue round
trip works on [0, 6), where one float32 step is 4.8e-7. Brightness,
contrast and saturation scale an error by their factor, so with factors
beyond the ranges (up to 3) the bound is 2e-6 times the largest factor.
`sample_jitter_params` is bit-equal for the same RandomState, and its
draws leave the RandomState where the host ColorJitter's do.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.data.transforms import ColorJitter as JaxColorJitter
from tripled_tpu.ops import jitter as jax_jitter
from tripled_tpu_torch.data.transforms import ColorJitter
from tripled_tpu_torch.ops import jitter

torch.set_num_threads(1)

TOL = 2e-6
ORDERS = list(itertools.permutations(range(4)))


def _frames(seed, b, f=2, h=12, w=20):
    """Random frames with rows of the edge cases of the HSV round trip:
    black, white, grey (r = g = b) and two channels tied at the max."""
    x = np.random.RandomState(seed).rand(b, f, h, w, 3).astype(np.float32)
    x[:, :, 0] = 0.0
    x[:, :, 1] = 1.0
    x[:, :, 2] = x[:, :, 2, :, :1]
    x[:, :, 3, :, 1] = x[:, :, 3, :, 0]
    return x


def _both(x, params):
    want = np.asarray(jax_jitter.color_jitter(jnp.asarray(x), jnp.asarray(params)))
    got = jitter.color_jitter(torch.from_numpy(x), torch.from_numpy(params)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    return got, want


@pytest.mark.parametrize("factors", ["drawn", "low", "high", "beyond"])
def test_color_jitter_matches_jax_over_all_orders(factors):
    b = len(ORDERS)
    rng = np.random.RandomState(7)
    lo_hi = {"low": ([0.8, 0.8, 0.8, -0.1], [0.8, 0.8, 0.8, -0.1]),
             "high": ([1.2, 1.2, 1.2, 0.1], [1.2, 1.2, 1.2, 0.1]),
             "drawn": ([0.8, 0.8, 0.8, -0.1], [1.2, 1.2, 1.2, 0.1]),
             "beyond": ([0.0, 0.0, 0.0, -0.5], [3.0, 3.0, 3.0, 0.5])}[factors]
    params = np.zeros((b, 9), np.float32)
    params[:, :4] = rng.uniform(*lo_hi, size=(b, 4))
    params[:, 4:8] = ORDERS
    params[:, 8] = 1.0
    x = _frames(3, b)
    got, want = _both(x, params)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, params[:, :3].max()))
    assert np.abs(got - x).max() > 1e-2  # the jitter did move the frames


def test_apply_zero_keeps_the_frames():
    b = len(ORDERS)
    params = np.zeros((b, 9), np.float32)
    params[:, :4] = np.random.RandomState(1).uniform(
        [0.8, 0.8, 0.8, -0.1], [1.2, 1.2, 1.2, 0.1], size=(b, 4))
    params[:, 4:8] = ORDERS
    params[::2, 8] = 1.0  # half apply, half keep
    x = _frames(4, b)
    got, want = _both(x, params)
    np.testing.assert_array_equal(got[1::2], x[1::2])
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the identity params of a sample without colour augmentation
    ident = np.tile(jitter.sample_jitter_params(None, None, False), (2, 1))
    np.testing.assert_array_equal(
        jitter.color_jitter(torch.from_numpy(x[:2]), torch.from_numpy(ident)).numpy(), x[:2])


@pytest.mark.parametrize("do_color_aug", [True, False])
def test_sample_jitter_params_bit_equal(do_color_aug):
    for seed in range(8):
        jrng, prng = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jax_jitter.sample_jitter_params(jrng, JaxColorJitter(), do_color_aug)
        got = jitter.sample_jitter_params(prng, ColorJitter(), do_color_aug)
        assert got.dtype == want.dtype == np.float32 and got.shape == (9,)
        np.testing.assert_array_equal(got, want)
        # the same draws as the host jitter: the next draw agrees
        hrng = np.random.RandomState(seed)
        if do_color_aug:
            ColorJitter().sample(hrng)
        assert prng.rand() == jrng.rand() == hrng.rand()
