"""One mono_fm training step of tripled_tpu_torch against the JAX package's,
on the CPU, from the same weights and inputs: every loss term, the gradient
norm, each parameter tensor's gradient, and the parameters after the Adam
update.

The model is cut to R18 depth / R18 pose / R18 extractor at 64x128, batch 2,
with decoder dropout off (the two packages cannot draw the same dropout
bits). The JAX step runs its XLA path (its Pallas kernel is TPU-only); the
port runs the plain version of its photometric kernel. The JAX gradients
are read from Adam's first moment after the step, (1 - b1) * gradient (no
weight decay, no clipping at these norms). This file holds automask off in
float32; `test_torch_port_step_automask.py` holds automask on and
`test_torch_port_step_f64.py` the same step in float64.

Float32 tolerances (TOL_F32) and why:
- Loss terms: rtol 2e-5, float32 rounding of sums taken in another order.
- Gradient norm: rtol 1e-3, and each tensor's gradient within 5e-2 of its
  norm (seen 1.2e-2, 1.9e-2 with automask; all in the pose encoder's early
  layers). The max pools (the ResNet stem's and the CRP decoder's 5x5
  pools, which see plateaus of nearly equal values) route a gradient by a
  last-bit comparison, which rounding decides differently in the two
  packages. In float64 every tensor's gradient agrees to 1e-13: the gap is
  conditioning, not a different function.
- Parameters after the update: the first Adam step moves each parameter by
  about lr * sign(g), so an element whose gradient is smaller than the
  gradients' disagreement can move the other way. Over the tensors the step
  moves (the frozen extractor's do not), at most 3% of the elements may
  differ by more than 1e-3 * lr (seen 1.6%). BatchNorm running statistics
  (flax's biased-variance update) agree to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.config import OptimConfig as JaxOptimConfig
from tripled_tpu.models.registry import build_model
from tripled_tpu.train.optim import make_optimizer
from tripled_tpu.train.state import TrainState
from tripled_tpu.train.step import make_train_step as jax_train_step
from tripled_tpu_torch.config import ModelConfig, OptimConfig
from tripled_tpu_torch.train.optim import Adam
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.train.step import make_train_step
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

B, H, W = 2, 64, 128
STEPS_PER_EPOCH = 100
LR0 = 1e-4 / 3  # warmup lr of the first update (warmup_ratio 1/3)
TOL_F32 = dict(loss=2e-5, f32_reduced_loss=2e-5, grad_norm=1e-3, grad=5e-2, param=None,
               flip_share=0.03, stats=1e-5)


def _model_kwargs(automask):
    return dict(name="mono_fm", depth_num_layers=18, pose_num_layers=18,
                extractor_num_layers=18, height=H, width=W, pose_height=H,
                pose_width=W, depth_dropout_rate=0.0, automask=automask)


def _inputs(dtype=np.float32):
    rng = np.random.RandomState(0)
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    K[:, 0, 0] = 0.58 * W
    K[:, 1, 1] = 1.92 * H
    K[:, 0, 2] = 0.5 * W
    K[:, 1, 2] = 0.5 * H
    return {
        "color": rng.rand(B, 3, H, W, 3).astype(dtype),
        "color_aug": rng.rand(B, 3, H, W, 3).astype(dtype),
        "K": K.astype(dtype),
        "inv_K": np.linalg.inv(K).astype(dtype),
    }


def _random_variables(model, inputs, dtype=np.float32):
    """The JAX package's variable tree, filled from a numpy seed (quicker
    than tracing the JAX init): kernels U(+-1/sqrt(fan_in)), BatchNorm scale
    and statistics near 1 and 0."""
    shapes = jax.eval_shape(
        lambda s: model.init({"params": jax.random.PRNGKey(0)}, s, train=True), inputs)
    rng = np.random.RandomState(1)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = fill(v)
            elif k == "kernel":
                b = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
                out[k] = rng.uniform(-b, b, v.shape).astype(dtype)
            else:
                lo, hi = {"scale": (0.8, 1.2), "var": (0.8, 1.2)}.get(k, (-0.1, 0.1))
                out[k] = rng.uniform(lo, hi, v.shape).astype(dtype)
        return out

    return fill(shapes["params"]), fill(shapes["batch_stats"])


def _port_model(automask, tdtype, params, stats):
    model = create_train_state(ModelConfig(**_model_kwargs(automask)), OptimConfig(),
                               STEPS_PER_EPOCH, device="cpu").model.to(tdtype)
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    return model


def run_both(automask, dtype=np.float32):
    """One step in each package. Returns (JAX metrics, port metrics, port
    model after the step, JAX parameters after the step and JAX gradients,
    each in a port model)."""
    inputs = _inputs(dtype)
    jmodel = build_model(JaxModelConfig(**_model_kwargs(automask)))
    params, stats = _random_variables(jmodel, inputs, dtype)
    tx, _ = make_optimizer(JaxOptimConfig(warmup_iters=2), steps_per_epoch=STEPS_PER_EPOCH)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params))
    rng = jax.random.PRNGKey(0)
    # float32: a lower XLA optimisation level compiles quicker and runs as
    # fast; float64 convolutions run 7x slower at that level
    options = {"xla_backend_optimization_level": 0} if dtype == np.float32 else None
    step = jax_train_step(jmodel, tx, donate=False).lower(state, inputs, rng).compile(options)
    new_state, jm = step(state, inputs, rng)
    jm = {k: float(v) for k, v in jm.items()}

    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    model = _port_model(automask, tdtype, params, stats)
    optimizer = Adam(model, OptimConfig(warmup_iters=2), STEPS_PER_EPOCH)
    tm = make_train_step(model, optimizer)(
        {k: torch.from_numpy(v) for k, v in inputs.items()})
    tm = {k: float(v) for k, v in tm.items()}

    ref = _port_model(automask, tdtype, new_state.params, new_state.batch_stats)
    # no weight decay, and the gradient norm is far below the clip norm: the
    # first Adam moment after one step is (1 - b1) * gradient
    assert jm["grad_norm"] < 35.0
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        new_state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
    jgrads = _port_model(automask, tdtype, jax.tree_util.tree_map(lambda m: m / 0.1, adam.mu),
                         stats)
    return jm, tm, model, ref, jgrads


def check_against_jax(jm, tm, model, ref, jgrads, automask, tol=TOL_F32):
    assert set(jm) == set(tm)
    for k in jm:
        if k == "grad_norm":
            np.testing.assert_allclose(tm[k], jm[k], rtol=tol["grad_norm"], err_msg=k)
        elif automask and (k.startswith("min_reconstruct") or k == "loss"):
            # the JAX step's N(0, 1e-5) tie-break noise on identity losses
            np.testing.assert_allclose(tm[k], jm[k], rtol=0, atol=2e-5, err_msg=k)
        elif k in ("loss", "min_perceptional_loss") or k.startswith("smooth_loss"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=tol["f32_reduced_loss"], err_msg=k)
        else:
            np.testing.assert_allclose(tm[k], jm[k], rtol=tol["loss"], err_msg=k)
    got, want = model.state_dict(), ref.state_dict()
    jgrad = dict(jgrads.named_parameters())
    n_far = n = 0
    for name, p in model.named_parameters():
        # the gradient, tensor by tensor (the frozen extractor's is zero)
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        scale = jgrad[name].norm().item()
        assert (g - jgrad[name]).norm().item() <= tol["grad"] * scale, name
        if scale == 0:
            continue
        # the parameters after the update, over the tensors the step moves
        d = (got[name] - want[name]).abs()
        if tol["param"] is not None:
            assert d.max().item() <= tol["param"] * LR0, name
        n_far += int((d > 1e-3 * LR0).sum())
        n += d.numel()
    assert n_far / n <= tol["flip_share"]
    for name, _ in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=tol["stats"], atol=tol["stats"], err_msg=name)


def test_mono_fm_step_matches_jax():
    check_against_jax(*run_both(automask=False), automask=False)
