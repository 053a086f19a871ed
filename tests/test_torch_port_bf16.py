"""Mixed precision (`compute_dtype="bfloat16"`) in tripled_tpu_torch
against the JAX package's bf16 step on the CPU, for the small mono_fm
(R18 everywhere, 64x128, batch 2, automask off, decoder dropout off) through
`run_both` / `check`; `test_torch_port_bf16_flagship.py` holds the small
flagship the same way. Here also: the JAX dtype contract, the loss
functions' dtypes, that float32 casts nothing, and that a bf16 remat JAX
tree loads into the port and predicts as the JAX predict does.

Both steps cast every floating parameter to bf16 inside the loss and feed
bf16 to the depth encoder, the extractor's target pass and the decoders;
BatchNorm statistics, warps, geometry and the losses' reductions stay
float32. The JAX step on the CPU scores float32 warped colours through its
XLA path (its kernel path is TPU-only); the port runs its kernel path,
bf16 slabs, on both devices. The port rounds where XLA computing the JAX
step does, on every device: the encoders' bf16 constants, a bf16
convolution's float32 result handed to BatchNorm unrounded
(`models/layers.py` `conv_bn`), the leaky ReLU's bf16 slope.

Tolerances (BF16_TOL), against gaps seen on the CPU (mono_fm; flagship),
beside the JAX package's own bf16-vs-float32 gap on the same weights:
- smooth_loss/*: rtol 5e-2, `tests/test_bf16.py`'s bound for the loss
  (seen 1.8e-2; 3.8e-2; JAX bf16 vs f32 2.0e-2; 3.0e-2). The disparity
  is bf16-rounded near 0.5 at init, so neighbour differences, which the
  term sums, are a few bf16 steps.
- every other loss term, the total included: rtol 5e-3, tighter than
  test_bf16.py's 5e-2 and 6e-2 (seen 4.8e-5; 6.5e-4 in
  img_reconstruct_loss/1).
- gradient norm: rtol 1e-2 (seen 4.2e-3; 2.5e-3; JAX bf16 vs f32 1.7e-2;
  1.4e-2).
- each tensor's gradient within 0.8 of its norm (seen 0.36; 0.41, in the
  depth encoder's BatchNorm scales and biases; JAX bf16 vs f32 0.57;
  0.56), and the median over tensors within 0.15 (seen 0.052; 0.079; JAX
  bf16 vs f32 0.32; 0.33): bf16 rounding and the max pools' near-ties,
  which bf16 makes far more frequent, route these gradients, and the port
  sits closer to the JAX bf16 step than that step sits to its own float32.
- BatchNorm running statistics: atol 1e-2 (seen 9.4e-4; 9.0e-4; JAX bf16
  vs f32 2.2e-3; 2.5e-3), from bf16 activations.
The parameters after the first Adam step are not compared: that step moves
each element by about lr * sign(g), and bf16 flips the sign of the small
gradients (half the elements in the JAX package's own bf16-vs-f32 step).
"""

import dataclasses

import numpy as np
import torch

from test_torch_port_step import kernels_not_drawn, mono_fm_kwargs, run_both
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops.losses import feature_regularization_loss, perceptional_loss, robust_l1
from tripled_tpu_torch.train.step import cast_floating

torch.set_num_threads(1)

BF16_TOL = dict(smooth=5e-2, loss=5e-3, grad_norm=1e-2, grad=0.8, grad_median=0.15, stats=1e-2)


def bf16_kwargs(kwargs):
    return dict(kwargs, compute_dtype="bfloat16")


def check(jm, tm, model, ref, jgrads, tol=BF16_TOL):
    """Every loss term, the gradient norm, each tensor's gradient and the
    running statistics against the JAX bf16 step; the dtype contract."""
    assert set(jm) == set(tm)
    for k in jm:
        if k == "grad_norm":
            rtol = tol["grad_norm"]
        elif k.startswith("smooth_loss"):
            rtol = tol["smooth"]
        else:
            rtol = tol["loss"]
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, err_msg=k)
    jgrad = dict(jgrads.named_parameters())
    gaps = []
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert g.dtype == torch.float32, name
        scale = jgrad[name].norm().item()
        if scale == 0:
            assert g.abs().max().item() == 0, name
            continue
        gaps.append((g - jgrad[name]).norm().item() / scale)
        assert gaps[-1] <= tol["grad"], (name, gaps[-1])
    assert np.median(gaps) <= tol["grad_median"], np.median(gaps)
    got, want = model.state_dict(), ref.state_dict()
    for name, buf in model.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32, name
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(), rtol=0,
                                       atol=tol["stats"], err_msg=name)


def test_mono_fm_bf16_step_matches_jax():
    jm, tm, model, ref, jgrads = run_both(bf16_kwargs(mono_fm_kwargs(automask=False)))
    check(jm, tm, model, ref, jgrads)


SMALL = dict(name="mono_fm_joint_inpaint_disentangle", depth_num_layers=18, pose_num_layers=18,
             extractor_num_layers=18, height=64, width=128, pose_height=64, pose_width=128,
             auto_res_weight=5e-3, disentangle_layers=(False, False, False, False, True),
             compute_dtype="bfloat16")


def test_optimizer_state_and_losses_stay_float32():
    from tripled_tpu_torch.config import OptimConfig
    from tripled_tpu_torch.train.state import create_train_state
    from tripled_tpu_torch.train.step import make_train_step
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    state = create_train_state(ModelConfig(**SMALL), OptimConfig(warmup_iters=2), 100,
                               device="cpu")
    batch = random_train_inputs(2, 64, 128, erase_count=4, erase_shape=(8, 8), device="cpu")
    metrics = make_train_step(state.model, state.optimizer)(batch, torch.Generator().manual_seed(0))
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and v.dim() == 0 and torch.isfinite(v), k
    saved = state.optimizer.state_dict()
    moments = [t for key in ("mu", "nu") for ts in saved[key].values() for t in ts]
    assert moments and all(t.dtype == torch.float32 for t in moments)
    assert all(t.dtype in (torch.float32, torch.int64) for t in state.model.state_dict().values())


def test_cast_floating_routes_gradients_to_the_float32_parameters():
    model = TripleDNet(ModelConfig(**SMALL))
    params = dict(model.named_parameters())
    conv = model.depth_encoder.encoder.conv1
    with cast_floating(model, torch.bfloat16):
        assert conv.weight.dtype == torch.bfloat16
        assert torch.equal(conv.weight, params["depth_encoder.encoder.conv1.weight"].bfloat16())
        (conv.weight.float() ** 2).sum().backward()
    assert dict(model.named_parameters()) == params  # the same objects, back in place
    grad = params["depth_encoder.encoder.conv1.weight"].grad
    assert grad.dtype == torch.float32
    assert torch.equal(grad, 2 * params["depth_encoder.encoder.conv1.weight"].bfloat16().float())


def test_float32_casts_nothing():
    model = TripleDNet(ModelConfig(**dict(SMALL, compute_dtype="float32")))
    x = torch.rand(2, 3, 8, 8)
    assert model._cd(x) is x and model._f32(x) is x
    xs = [x, x + 1]
    assert all(a is b for a, b in zip(model._cd(xs), xs))
    bf = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
    assert TripleDNet(bf)._cd(x).dtype == torch.bfloat16
    assert TripleDNet(bf)._f32(x.bfloat16()).dtype == torch.float32


def test_feature_losses_keep_elementwise_dtype_and_reduce_in_float32():
    rng = np.random.RandomState(3)
    f = torch.from_numpy(rng.randn(2, 12, 20, 8).astype(np.float32))
    g = torch.from_numpy(rng.randn(2, 12, 20, 8).astype(np.float32))
    img = torch.from_numpy(rng.rand(2, 48, 80, 3).astype(np.float32))
    # float32: bit-identical to the direct float32 computation
    p = perceptional_loss(f, g)
    assert p.dtype == torch.float32
    torch.testing.assert_close(p, torch.sqrt((f - g) ** 2 + 1e-6).mean(-1, keepdim=True),
                               rtol=0, atol=0)
    # bf16: the Charbonnier in bf16, its channel mean in float32
    fb, gb = f.bfloat16(), g.bfloat16()
    pb = perceptional_loss(fb, gb)
    assert pb.dtype == torch.float32
    torch.testing.assert_close(pb, robust_l1(fb, gb).float().mean(-1, keepdim=True), rtol=0,
                               atol=0)
    r = feature_regularization_loss(f, img, dis=1e-3, cvt=1e-3)
    rb = feature_regularization_loss(fb, img, dis=1e-3, cvt=1e-3)
    assert r.dtype == rb.dtype == torch.float32 and torch.isfinite(rb)
    np.testing.assert_allclose(rb.item(), r.item(), rtol=2e-2)


def test_bf16_remat_jax_tree_loads_and_predicts_as_jax():
    """A JAX model with compute_dtype="bfloat16" and remat keeps a float32
    tree (renamed ResNets); it loads unchanged into the port's bf16 model,
    whose prediction, on float32 parameters and a bf16-rounded image as
    the JAX predict computes it, agrees with the JAX package's."""
    import jax

    from test_torch_port_flagship import flagship_inputs, flagship_kwargs
    from test_torch_port_step import _random_variables
    from tripled_tpu.config import ModelConfig as JaxModelConfig
    from tripled_tpu.models.registry import build_model
    from tripled_tpu.train.step import make_predict_fn as jax_make_predict_fn
    from tripled_tpu_torch.train.step import make_predict_fn
    from tripled_tpu_torch.utils.jax_weights import load_jax_variables

    kw = bf16_kwargs(dict(flagship_kwargs(), remat=True))
    jmodel = build_model(JaxModelConfig(**kw))
    inputs = flagship_inputs()
    shapes = jax.eval_shape(
        lambda s: jmodel.init({"params": jax.random.PRNGKey(0)}, s, train=True), inputs)
    leaves = jax.tree_util.tree_leaves(shapes)
    assert leaves and all(leaf.dtype == np.float32 for leaf in leaves)
    assert "CheckpointResNetFeatures_0" in shapes["params"]["depth_encoder"]
    params, stats = _random_variables(jmodel, inputs)
    with kernels_not_drawn():  # the load overwrites every parameter
        model = TripleDNet(ModelConfig(**kw))
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    images = inputs["color"][:, :1]
    want = np.asarray(jax_make_predict_fn(jmodel)({"params": params, "batch_stats": stats},
                                                  images))
    got = make_predict_fn(model)(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32
    # rtol 1e-3 (seen 1.5e-4): the image is normalised in bf16 and the
    # networks compute in float32 on it; float32 summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-3)
