"""The modules the flagship (TripleDNet, mono_fm_joint_inpaint_disentangle)
adds to tripled_tpu_torch, each against the JAX package's on the CPU.

Networks and losses with their gradients are held in float64, where the two
packages compute the same function: 1e-9 relative to the largest value.
The erase mask is held bit for bit (the same numpy draws), the resize in
float32 at 1e-5 / 1e-6 (float32 rounding of two weighted sums), and the
presets field by field.
"""

import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tripled_tpu.config as jcfg
import tripled_tpu.models.decoders as jdec
from test_torch_port_flagship import flagship_inputs, flagship_kwargs
from test_torch_port_models import _close, _nchw, _nhwc, _random_variables
from test_torch_port_step import kernels_not_drawn
from tripled_tpu.data.transforms import make_erase_mask as jax_make_erase_mask
from tripled_tpu.models.layers import identity_partial as jax_identity_partial
from tripled_tpu.models.registry import build_model
from tripled_tpu.ops import image as jimg
from tripled_tpu.ops import losses as jloss
from tripled_tpu.train.step import make_predict_fn as jax_predict_fn
from tripled_tpu_torch import presets
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.data.transforms import make_erase_mask
from tripled_tpu_torch.models import decoders as tdec
from tripled_tpu_torch.models.layers import identity_partial
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops import image as timg
from tripled_tpu_torch.ops import losses as tloss
from tripled_tpu_torch.train.step import make_predict_fn
from tripled_tpu_torch.utils.inputs import random_train_inputs
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, H, W = 2, 64, 128
CHANNELS = (64, 64, 128, 256, 256)  # R18 with the last stage halved


def _pyramid(rng, channels=CHANNELS):
    return [rng.randn(B, H // s, W // s, c) for c, s in zip(channels, (2, 4, 8, 16, 32))]


def test_image_decoder_matches_jax(rng_np):
    feats = _pyramid(rng_np, (64, 64, 128, 256, 512))
    with jax.enable_x64(True):
        jm = jdec.ImageDecoder(3)
        v = _random_variables(jm, feats, dtype=np.float64)
        apply = jax.jit(lambda fs: jm.apply(v, fs))
        imgs = apply(feats)
        weights = [rng_np.rand(*x.shape) for x in imgs]
        jgrad = jax.jit(jax.grad(lambda fs: sum(
            (x * w).sum() for x, w in zip(apply(fs), weights))))(feats)[4]
    tm = tdec.ImageDecoder(512, 3).double()
    load_jax_variables(tm, v["params"], {})
    tfeats = [_nchw(f).requires_grad_() for f in feats]
    timgs = tm(tfeats)
    assert [tuple(x.shape[2:]) for x in timgs] == [(H, W), (H // 2, W // 2),
                                                   (H // 4, W // 4), (H // 8, W // 8)]
    sum((x * _nchw(w)).sum() for x, w in zip(timgs, weights)).backward()
    for x, jx in zip(timgs, imgs):
        _close(_nhwc(x), jx, 1e-9)
    _close(_nhwc(tfeats[4].grad), jgrad, 1e-9)


@pytest.mark.parametrize("skip_layers", [(False,) * 4, (True, False, True, False)])
def test_color_decoder_matches_jax(skip_layers, rng_np):
    feats = _pyramid(rng_np)
    disps = [rng_np.rand(B, H // s, W // s, 1) for s in (2, 4, 8, 16)]
    with jax.enable_x64(True):
        jm = jdec.ColorDecoder(3, skip_connection_multiplier=0.7, skip_layers=skip_layers)
        v = _random_variables(jm, feats, disps, dtype=np.float64)
        apply = jax.jit(lambda fs, ds: jm.apply(v, fs, ds))
        imgs = apply(feats, disps)
        weights = [rng_np.rand(*x.shape) for x in imgs]
        jgf, jgd = jax.jit(jax.grad(lambda fs, ds: sum(
            (x * w).sum() for x, w in zip(apply(fs, ds), weights)), argnums=(0, 1)))(feats, disps)
    tm = tdec.ColorDecoder(CHANNELS, 3, skip_connection_multiplier=0.7,
                           skip_layers=skip_layers).double()
    load_jax_variables(tm, v["params"], {})
    tfeats = [_nchw(f).requires_grad_() for f in feats]
    tdisps = [_nchw(d).requires_grad_() for d in disps]
    timgs = tm(tfeats, tdisps)
    sum((x * _nchw(w)).sum() for x, w in zip(timgs, weights)).backward()
    for x, jx in zip(timgs, imgs):
        _close(_nhwc(x), jx, 1e-9)
    # stage 4 always feeds the decoder; stage 3 - j only through skip j
    used = [True] + list(skip_layers)
    for t, g, u in zip(tfeats[::-1] + tdisps, list(jgf[::-1]) + list(jgd), used + [True] * 4):
        if u:
            _close(_nhwc(t.grad), g, 1e-9)
        else:
            assert t.grad is None and not np.asarray(g).any()


def test_identity_partial(rng_np):
    x = rng_np.randn(2, 3, 4, 6)
    for right in (False, True):
        _close(_nhwc(identity_partial(_nchw(x), 2, use_right=right)),
               jax_identity_partial(x, 2, use_right=right), 0)


@pytest.mark.parametrize("hw", [(32, 64), (4, 8), (2, 4)])
def test_feature_regularization_loss_matches_jax(hw, rng_np):
    """Down to a 2-row map, whose second-order y terms are empty (zero)."""
    h, w = hw
    feat = rng_np.randn(B, h, w, 8)
    img = rng_np.rand(B, 64, 128, 3)
    with jax.enable_x64(True):
        val, grad = jax.jit(jax.value_and_grad(
            lambda f: jloss.feature_regularization_loss(f, img, 1e-3, 2e-3)))(feat)
    tf = torch.from_numpy(feat).requires_grad_()
    out = tloss.feature_regularization_loss(tf, torch.from_numpy(img), 1e-3, 2e-3)
    out.backward()
    # both packages reduce _edge_weighted's terms in float32
    np.testing.assert_allclose(out.item(), float(val), rtol=1e-6)
    _close(tf.grad.numpy(), grad, 1e-9)


def test_erased_mean_matches_jax(rng_np):
    rec = rng_np.rand(B, 40, 80, 1)
    mask = jimg.resize_bilinear(
        np.stack([jax_make_erase_mask(rng_np, 80, 160, (16, 16), 5) for _ in range(B)]), 40, 80)
    mask = np.asarray(mask, np.float64)
    with jax.enable_x64(True):
        val, grad = jax.value_and_grad(
            lambda r: jnp.sum(r * (1 - mask)) / jnp.sum(1 - mask))(rec)
    tr = torch.from_numpy(rec).requires_grad_()
    out = tloss.erased_mean(tr, torch.from_numpy(mask))
    out.backward()
    np.testing.assert_allclose(out.item(), float(val), rtol=1e-12)
    _close(tr.grad.numpy(), grad, 1e-12)


@pytest.mark.parametrize("count,shape", [(16, (16, 16)), (1, (16, 16)), (5, (8, 24))])
def test_make_erase_mask_bit_equal(count, shape):
    a = make_erase_mask(np.random.RandomState(3), 64, 160, shape, count)
    b = jax_make_erase_mask(np.random.RandomState(3), 64, 160, shape, count)
    assert a.dtype == b.dtype == np.float32 and a.shape == (64, 160, 1)
    assert np.array_equal(a, b) and (a == 0).any()


def test_random_train_inputs_mask():
    """One mask per sample, drawn after the frames from the same RandomState."""
    batch = random_train_inputs(3, 32, 64, seed=4, erase_count=4, erase_shape=(8, 8),
                                device="cpu")
    rng = np.random.RandomState(4)
    rng.rand(3, 3, 32, 64, 3)
    rng.rand(3, 3, 32, 64, 3)
    want = np.stack([jax_make_erase_mask(rng, 32, 64, (8, 8), 4) for _ in range(3)])
    assert np.array_equal(batch["mask"].numpy(), want)
    assert "mask" not in random_train_inputs(1, 8, 8, device="cpu")


def test_resize_bilinear_flagship_to_pose(rng_np):
    """The pose input's resize at the flagship's size, 320x1024 -> 192x640
    (factors 0.6 and 0.625), with its gradient."""
    x = rng_np.rand(1, 320, 1024, 3).astype(np.float32)
    want = jimg.resize_bilinear(x, 192, 640)
    w = rng_np.rand(*want.shape).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jimg.resize_bilinear(a, 192, 640) * w))(x)
    tx = torch.from_numpy(x).requires_grad_()
    got = timg.resize_bilinear(tx, 192, 640)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-6)


def test_load_jax_variables_from_remat_flagship(rng_np):
    """The flagship config's own setting, remat=True, renames each encoder's
    ResNet; its tree loads whole (nothing unused, nothing unwritten) and
    predicts what the JAX model predicts."""
    kw = flagship_kwargs()
    jm = build_model(jcfg.ModelConfig(**kw, remat=True))
    inputs = flagship_inputs()
    v = _random_variables(jm, inputs, train=True)
    assert "CheckpointResNetFeatures_0" in v["params"]["extractor"]
    with kernels_not_drawn():  # the load overwrites every parameter
        tm = TripleDNet(ModelConfig(**kw))
    load_jax_variables(tm, v["params"], v["batch_stats"])
    images = inputs["color"][:, :1]
    want = jax_predict_fn(jm)(v, images)
    got = make_predict_fn(tm)(torch.from_numpy(images))
    _close(got.numpy(), want, 1e-4)


PRESET_NAMES = sorted(presets.PRESETS)


@pytest.mark.parametrize("name", PRESET_NAMES)
def test_presets_match_jax_registry(name):
    from tripled_tpu.models.registry import _PRESETS

    base = dict(perception_weight=1e-3, img_reconstruct_weight=1.0)
    got = presets.canonicalize(ModelConfig(name=name, **base))
    want = _PRESETS[name](jcfg.ModelConfig(name=name, **base))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_flagship_bench_is_the_flagship_config():
    sys.path.insert(0, str(REPO / "configs"))
    try:
        exp = importlib.import_module("cfg_kitti_tripled").config
    finally:
        sys.path.remove(str(REPO / "configs"))
    model, data, optim = presets.flagship_bench()
    want = presets.canonicalize(ModelConfig(**{
        f.name: getattr(exp.model, f.name) for f in dataclasses.fields(ModelConfig)}))
    assert model == want
    assert (model.depth_num_layers, model.pose_num_layers, model.extractor_num_layers) == (50, 18, 50)
    assert (model.height, model.width, model.pose_height, model.pose_width) == (320, 1024, 192, 640)
    assert exp.model.remat and exp.model.compute_dtype == "float32"
    assert (data.batch_size, data.erase_count, tuple(data.erase_shape)) == (
        exp.data.batch_size, exp.data.erase_count, tuple(exp.data.erase_shape))
    assert optim.lr_steps == exp.optim.lr_steps


@pytest.mark.parametrize("field,value", [("depth_skip_type", "ca"), ("depth_skip_type", "pa"),
                                         ("depth_skip_type", "asca"), ("depth_skip_type", "1x1"),
                                         ("color_skip_type", "1x1"), ("use_pfp", True),
                                         ("depth_disentangle_type", "1x1"),
                                         ("use_hr_depth", True), ("use_diffnet", True),
                                         ("depth_use_shuffle", True)])
def test_config_accepts_architecture_options(field, value):
    """Each architecture option is a field of the JAX ModelConfig's, with its
    default, and the port's config takes the value as the JAX one does."""
    port_default = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    jax_default = {f.name: f.default for f in dataclasses.fields(jcfg.ModelConfig)}
    assert port_default[field] == jax_default[field]
    assert getattr(ModelConfig(**{field: value}), field) == getattr(
        jcfg.ModelConfig(**{field: value}), field) == value
