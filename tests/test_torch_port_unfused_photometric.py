"""The unfused photometric path of tripled_tpu_torch
(`use_pallas_photometric=False`, `models/net.py`), on the CPU: each
candidate's reprojection loss and `ops/losses.min_reprojection_with_automask`
with the 1e-5 tie-break noise on the identity losses.

- `min_reprojection_with_automask` against the JAX function with the same
  noise: the JAX package draws N(0, 1) * 1e-5 from its key, and the port is
  handed that array. The same float operations (an add, a min): equal bit
  for bit, in float32 and float64.
- The noise the port draws: from the `automask` generator on the model's
  device, one draw per scale, of the identity losses' shape (B, H, W,
  sources) and dtype; its standard deviation within 5% of 1e-5 (24576
  samples a draw: the estimate's own spread is 0.5%) and its mean within
  five standard errors of 0; none with automask off. The fused path is not called.
- With automask off the unfused loss is the fused path's plain version's
  on random inputs (without noise the two differ only on exact ties):
  every loss term within 1e-12 and every gradient within 1e-10 of its
  norm in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.ops.losses import min_reprojection_with_automask as jax_min_reprojection
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models import net as net_module
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops.losses import min_reprojection_with_automask
from tripled_tpu_torch.utils.inputs import random_train_inputs

torch.set_num_threads(1)

B, H, W = 2, 64, 96
SMALL = dict(name="mono_baseline", depth_num_layers=18, pose_num_layers=18, height=H, width=W,
             pose_height=H, pose_width=W, depth_dropout_rate=0.0, use_pallas_photometric=False)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_id", [0, 2])
def test_min_reprojection_matches_jax_with_the_same_noise(dtype, n_id):
    rng = np.random.RandomState(n_id)
    preds = [rng.rand(B, H, W, 1).astype(dtype) for _ in range(2)]
    idents = [rng.rand(B, H, W, 1).astype(dtype) for _ in range(n_id)]
    # exact ties between the identity and warped losses, where the noise decides
    if idents:
        idents[0][:, :8] = preds[1][:, :8]
    key = jax.random.PRNGKey(3)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax_min_reprojection([jnp.asarray(p) for p in preds],
                                               [jnp.asarray(p) for p in idents], key))
        noise = None
        if idents:
            noise = torch.from_numpy(np.asarray(
                jax.random.normal(key, (B, H, W, n_id), dtype) * 1e-5))
    got = min_reprojection_with_automask([torch.from_numpy(p) for p in preds],
                                         [torch.from_numpy(p) for p in idents], noise)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def model():
    return TripleDNet(ModelConfig(**SMALL, automask=True)).train()


def _drawn_noise(model, monkeypatch, seed):
    """The noise arrays the model's loss hands min_reprojection_with_automask
    in one training forward, with the automask generator seeded `seed`."""
    seen = []

    def spy(preds, idents, noise=None):
        seen.append(noise)
        return min_reprojection_with_automask(preds, idents, noise)

    def fused(*args, **kwargs):
        raise AssertionError("the fused path ran under use_pallas_photometric=False")

    monkeypatch.setattr(net_module, "min_reprojection_with_automask", spy)
    monkeypatch.setattr(net_module, "fused_min_reprojection", fused)
    inputs = random_train_inputs(B, H, W, seed=0, device="cpu")
    with torch.no_grad():
        model(inputs, None, None, torch.Generator().manual_seed(seed))
    return seen


def test_the_port_draws_the_noise(model, monkeypatch):
    seen = _drawn_noise(model, monkeypatch, seed=2)
    assert len(seen) == len(model.cfg.scales)
    for noise in seen:
        assert noise.shape == (B, H, W, 2) and noise.dtype == torch.float32
        assert noise.device == torch.device("cpu")
        # the mean within five of its standard errors, 1e-5 / sqrt(n)
        assert abs(noise.std().item() / 1e-5 - 1) < 0.05
        assert abs(noise.mean().item()) < 5 * 1e-5 / noise.numel() ** 0.5
    assert not torch.equal(seen[0], seen[1])  # a draw a scale
    again = _drawn_noise(model, monkeypatch, seed=2)
    assert all(torch.equal(a, b) for a, b in zip(seen, again))
    other = _drawn_noise(model, monkeypatch, seed=3)
    assert not torch.equal(seen[0], other[0])


def test_no_noise_without_automask(monkeypatch):
    model = TripleDNet(ModelConfig(**SMALL, automask=False)).train()
    seen = _drawn_noise(model, monkeypatch, seed=2)
    assert seen == [None] * len(model.cfg.scales)


def test_unfused_equals_fused_plain_without_automask():
    torch.manual_seed(0)
    models = {flag: TripleDNet(ModelConfig(**{**SMALL, "use_pallas_photometric": flag},
                                           automask=False)).double().train()
              for flag in (True, False)}
    models[False].load_state_dict(models[True].state_dict())
    inputs = {k: v.double() for k, v in random_train_inputs(B, H, W, seed=1, device="cpu").items()}
    losses = {}
    for flag, model in models.items():
        loss_dict = model(inputs)[1]
        sum(loss_dict.values()).backward()
        losses[flag] = {k: v.item() for k, v in loss_dict.items()}
    assert losses[True].keys() == losses[False].keys()
    for k in losses[True]:
        np.testing.assert_allclose(losses[False][k], losses[True][k], rtol=1e-12, err_msg=k)
    grads = {flag: dict(m.named_parameters()) for flag, m in models.items()}
    for name, p in grads[True].items():
        q = grads[False][name]
        assert (p.grad - q.grad).norm() <= 1e-10 * p.grad.norm(), name
