"""tripled_tpu_torch's networks against the JAX package's at R18 on 64x128,
weights carried by `load_jax_variables`, on the CPU.

Train-mode outputs, BatchNorm running statistics and input gradients are
held in float64, where the two packages must agree to 1e-9: this includes
the max pools, whose float32 gradients can route a near-tie to another
element (see test_torch_port_step.py). Eval-mode outputs are held in
float32 at 1e-4 relative, float32 rounding through some twenty layers.
"""

import jax
import numpy as np
import pytest
import torch

import tripled_tpu.models.depth_decoder as jdd
import tripled_tpu.models.encoders as jenc
import tripled_tpu.models.pose_decoder as jpd
from test_torch_port_step import kernels_not_drawn
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models.registry import build_model
from tripled_tpu.train.step import make_predict_fn as jax_predict_fn
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models import depth_decoder as tdd
from tripled_tpu_torch.models import encoders as tenc
from tripled_tpu_torch.models import pose_decoder as tpd
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.train.step import make_predict_fn
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

B, H, W = 2, 64, 128
CHANNELS = (64, 64, 128, 256, 512)


def _random_variables(module, *args, dtype=np.float32, **kwargs):
    """The module's JAX variable tree filled from a numpy seed."""
    shapes = jax.eval_shape(
        lambda *a: module.init({"params": jax.random.PRNGKey(0)}, *a, **kwargs), *args)
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

    return {k: fill(v) for k, v in shapes.items()}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(t):
    return t.detach().movedim(1, -1).numpy()


def _close(got, want, rtol):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=rtol * np.abs(want).max())


ENCODERS = {
    "depth": (lambda: jenc.DepthEncoder(18), lambda: tenc.DepthEncoder(18), 3),
    "pose": (lambda: jenc.PoseEncoder(18, 2), lambda: tenc.PoseEncoder(18, 2), 6),
    "extractor": (lambda: jenc.Extractor(18), lambda: tenc.Extractor(18), 3),
}


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_encoder_matches_jax(name, rng_np):
    jax_cls, torch_cls, cin = ENCODERS[name]
    x = rng_np.rand(B, H, W, cin)
    with jax.enable_x64(True):
        jm = jax_cls()
        v = _random_variables(jm, x, dtype=np.float64, train=True)
        apply = jax.jit(lambda a: jm.apply(v, a, train=True, mutable=["batch_stats"]))
        feats, mutated = apply(x)
        weights = [rng_np.rand(*f.shape) for f in feats]
        jgrad = jax.jit(jax.grad(lambda a: sum(
            (f * w).sum() for f, w in zip(apply(a)[0], weights))))(x)

    tm = torch_cls().double()
    load_jax_variables(tm, v["params"], v["batch_stats"])
    tx = _nchw(x).requires_grad_()
    tfeats = tm(tx)
    sum((f * _nchw(w)).sum() for f, w in zip(tfeats, weights)).backward()
    for f, jf in zip(tfeats, feats):
        _close(_nhwc(f), jf, 1e-9)
    _close(_nhwc(tx.grad), jgrad, 1e-9)
    # running statistics after the train-mode forward (flax's update)
    ref = torch_cls().double()
    load_jax_variables(ref, v["params"], jax.tree_util.tree_map(np.asarray, mutated["batch_stats"]))
    for (n, got), (_, want) in zip(tm.named_buffers(), ref.named_buffers()):
        if "running" in n:
            _close(got.numpy(), want.numpy(), 1e-9)

    # eval mode, float32
    xf = x.astype(np.float32)
    v32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    jfeats = jax.jit(lambda a: jm.apply(v32, a, train=False))(xf)
    tm32 = torch_cls()
    load_jax_variables(tm32, v32["params"], v32["batch_stats"])
    with torch.no_grad():
        for f, jf in zip(tm32.eval()(_nchw(xf)), jfeats):
            _close(_nhwc(f), jf, 1e-4)


def test_depth_decoder_matches_jax(rng_np):
    feats = [rng_np.randn(B, H // s, W // s, c)
             for c, s in zip(CHANNELS, (2, 4, 8, 16, 32))]
    with jax.enable_x64(True):
        jm = jdd.DepthDecoder(CHANNELS, dropout_rate=0.0)
        v = _random_variables(jm, feats, dtype=np.float64, train=False)
        apply = jax.jit(lambda fs: jm.apply(v, fs, train=True))
        disps = apply(feats)
        weights = [rng_np.rand(*d.shape) for d in disps]
        jgrads = jax.jit(jax.grad(lambda fs: sum(
            (d * w).sum() for d, w in zip(apply(fs), weights))))(feats)

    tm = tdd.DepthDecoder(CHANNELS, dropout_rate=0.0).double()
    load_jax_variables(tm, v["params"], {})
    tfeats = [_nchw(f).requires_grad_() for f in feats]
    tdisps = tm(tfeats)
    sum((d * _nchw(w)).sum() for d, w in zip(tdisps, weights)).backward()
    for d, jd in zip(tdisps, disps):
        _close(_nhwc(d), jd, 1e-9)
    for tf, jg in zip(tfeats[1:], jgrads[1:]):
        _close(_nhwc(tf.grad), jg, 1e-9)


def test_pose_decoder_matches_jax(rng_np):
    bottom = rng_np.randn(B, 2, 4, 512).astype(np.float32)
    jm = jpd.PoseDecoder()
    v = _random_variables(jm, bottom)
    aa, tr = jm.apply(v, bottom)
    tm = tpd.PoseDecoder(512)
    load_jax_variables(tm, v["params"], {})
    with torch.no_grad():
        taa, ttr = tm(_nchw(bottom))
    _close(taa.numpy(), aa, 1e-5)
    _close(ttr.numpy(), tr, 1e-5)


def test_predict_fn_matches_jax(rng_np):
    """Eval-mode prediction through both packages' entry points."""
    kw = dict(name="mono_fm", depth_num_layers=18, pose_num_layers=18,
              extractor_num_layers=18, height=H, width=W, pose_height=H, pose_width=W)
    images = rng_np.rand(B, 1, H, W, 3).astype(np.float32)
    frames = rng_np.rand(B, 3, H, W, 3).astype(np.float32)
    K = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    jm = build_model(JaxModelConfig(**kw))
    v = _random_variables(jm, {"color": frames, "color_aug": frames, "K": K, "inv_K": K},
                          train=True)
    want = jax_predict_fn(jm)(v, images)
    with kernels_not_drawn():  # the load overwrites every parameter
        tm = TripleDNet(ModelConfig(**kw))
    load_jax_variables(tm, v["params"], v["batch_stats"])
    got = make_predict_fn(tm)(torch.from_numpy(images))
    assert got.shape == (B, H // 2, W // 2, 1)
    _close(got.numpy(), want, 1e-4)


def test_dropout_keep_rate():
    x = torch.ones(1000, 1000)
    y = tdd.dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert abs((y != 0).float().mean().item() - 0.5) < 0.005
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    torch.testing.assert_close(y, tdd.dropout(x, 0.5, torch.Generator().manual_seed(0)))


def test_load_jax_variables_checks_every_key(rng_np):
    jm = jpd.PoseDecoder()
    v = _random_variables(jm, rng_np.randn(1, 2, 4, 512).astype(np.float32))
    params = v["params"]
    missing = {k: val for k, val in params.items() if k != "Conv_3"}
    with pytest.raises(KeyError, match="Conv_3"):
        load_jax_variables(tpd.PoseDecoder(512), missing, {})
    extra = dict(params, Conv_9={"kernel": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="Conv_9"):
        load_jax_variables(tpd.PoseDecoder(512), extra, {})
