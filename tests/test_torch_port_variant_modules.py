"""The architecture options' layers of tripled_tpu_torch against the JAX
package's, one by one, on the CPU in float64: the align-corners resize
(`ops/image.py`), the skip attentions (squeeze-excitation, channel and
pixel attention, contrast-aware attention, ASCA), `UpShuffle`, HR-Depth's
`FSEModule`, DIFFNet's `ChannelAttention` and `AttentionModule`, and both
HR decoders; also the pixel shuffle's channel order, the sub-pixel init,
and the config's refusals. HRNet is `test_torch_port_variant_hrnet.py`.

Each layer gets the same variables (numpy seed, carried by the loader's
own per-layer functions) and the same inputs in both packages. Held: the
outputs, and the gradients of one scalar of them (each output times a
fixed random tensor, summed) with respect to every input and every
parameter. TOL = 1e-9 of the largest magnitude (outputs) or of the norm
(each gradient tensor): float64 rounding of sums taken in other orders is
about 1e-15 here; a wrong index, init-free formula or channel order is
far above it.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models import hr_decoders as jdec
from tripled_tpu.models import layers as jl
from tripled_tpu.ops.image import _linear_matrix_align_corners
from tripled_tpu.ops.image import resize_bilinear_align_corners as jax_resize_ac
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models import hr_decoders as tdec
from tripled_tpu_torch.models import layers as tl
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.ops.image import _align_corners_matrix, resize_bilinear_align_corners
from tripled_tpu_torch.utils.jax_weights import _Loader

torch.set_num_threads(1)

TOL = 1e-9


def _fill(tree, rng):
    """JAX variables from a numpy seed: kernels U(+-1/sqrt(fan_in)),
    BatchNorm scale and variance in [0.8, 1.2], the rest in +-0.1."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = _fill(v, rng)
        elif k == "kernel":
            b = 1.0 / np.sqrt(np.prod(v.shape[:-1]))
            out[k] = rng.uniform(-b, b, v.shape)
        else:
            lo, hi = {"scale": (0.8, 1.2), "var": (0.8, 1.2)}.get(k, (-0.1, 0.1))
            out[k] = rng.uniform(lo, hi, v.shape)
    return out


def _nchw(a):
    return a.permute(0, 3, 1, 2) if a.dim() == 4 else a


def _nhwc(a):
    return a.permute(0, 2, 3, 1) if a.dim() == 4 else a


def _close(got, want, what):
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= TOL * scale, (what, np.abs(got - want).max(), scale)


def compare(jmod, args, port, load, train=False, seed=0):
    """Hold `port` (float64) against the flax module `jmod` on `args`
    (NHWC numpy arrays, nested lists allowed): outputs, input gradients and
    parameter gradients of sum(output * weight); with `train`, BatchNorm in
    batch-statistics mode, and the running statistics after it. `load(loader,
    module)` writes a JAX variable tree into a port module. Returns the
    JAX outputs."""
    rng = np.random.RandomState(seed)
    with jax.enable_x64(True):
        jargs = jax.tree_util.tree_map(jnp.asarray, args)
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), *jargs))
        variables = _fill(dict(shapes), rng)
        stats = variables.get("batch_stats", {})

        def apply(params, a):
            v = {"params": params, **({"batch_stats": stats} if stats else {})}
            if train:
                return jmod.apply(v, *a, mutable=["batch_stats"])
            return jmod.apply(v, *a), {}

        def scalar(params, a):
            outs, upd = apply(params, a)
            leaves = jax.tree_util.tree_leaves(outs)
            keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
            weights = [jax.random.normal(k, o.shape, o.dtype) for k, o in zip(keys, leaves)]
            return sum(jnp.sum(o * w) for o, w in zip(leaves, weights)), (leaves, upd, weights)

        (_, (jouts, jupd, weights)), (gparams, gargs) = jax.jit(
            jax.value_and_grad(scalar, argnums=(0, 1), has_aux=True))(variables["params"], jargs)
        jouts, weights = [[np.asarray(o) for o in t] for t in (jouts, weights)]

    port = port.double().train(train)
    load(_Loader(variables["params"], stats), port)
    targs = jax.tree_util.tree_map(
        lambda a: _nchw(torch.from_numpy(np.array(a))).requires_grad_(), args)
    touts = [_nhwc(o) for o in jax.tree_util.tree_leaves(port(*targs), is_leaf=torch.is_tensor)]
    assert len(touts) == len(jouts)
    total = sum((o * torch.from_numpy(w)).sum() for o, w in zip(touts, weights))
    total.backward()
    for i, (t, j) in enumerate(zip(touts, jouts)):
        _close(t.detach().numpy(), j, f"output {i}")
    for i, (t, j) in enumerate(zip(jax.tree_util.tree_leaves(targs, is_leaf=torch.is_tensor),
                                   jax.tree_util.tree_leaves(gargs))):
        _close(_nhwc(t.grad).numpy(), np.asarray(j), f"input gradient {i}")
    grads = copy.deepcopy(port)
    load(_Loader(jax.tree_util.tree_map(np.asarray, gparams), stats), grads)
    want = dict(grads.named_parameters())
    for name, p in port.named_parameters():
        g, w = p.grad.numpy(), want[name].detach().numpy()
        assert np.linalg.norm(g - w) <= TOL * np.linalg.norm(w), (name, np.linalg.norm(g - w))
    if train:
        upd = jax.tree_util.tree_map(np.asarray, jupd["batch_stats"])
        ran = copy.deepcopy(port)
        load(_Loader(variables["params"], upd), ran)
        moved = dict(ran.named_buffers())
        for name, b in port.named_buffers():
            if "running" in name:
                w = moved[name].numpy()
                assert np.abs(b.numpy() - w).max() <= TOL * np.abs(w).max(), name
    return jouts


# ------------------------------------------------------------ resize


@pytest.mark.parametrize("n_in,n_out", [(5, 9), (12, 24), (36, 72), (8, 16), (4, 4), (1, 6),
                                        (6, 1), (9, 5)])
def test_align_corners_matrix_is_the_jax_matrix(n_in, n_out):
    """Bit for bit at a float64 input, as the JAX package computes it under
    jit (its train and predict steps): float32 positions, then the cast.
    Eager JAX divides where XLA multiplies by a folded reciprocal; the two
    differ at 12 -> 24, 36 -> 72 and 8 -> 16."""
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(
            lambda: _linear_matrix_align_corners(n_in, n_out, jnp.float64))())
        eager = np.asarray(_linear_matrix_align_corners(n_in, n_out, jnp.float64))
    got = _align_corners_matrix(n_in, n_out, torch.float64, "cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert np.array_equal(eager, want) == ((n_in, n_out) not in [(12, 24), (36, 72), (8, 16)])


def test_resize_align_corners_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.standard_normal((2, 12, 9, 4))
    w = rng.standard_normal((2, 24, 17, 4))
    with jax.enable_x64(True):
        f = jax.jit(lambda a: jnp.sum(jax_resize_ac(a, 24, 17) * w))
        want = np.asarray(jax.jit(lambda a: jax_resize_ac(a, 24, 17))(jnp.asarray(x)))
        want_grad = np.asarray(jax.grad(f)(jnp.asarray(x)))
    t = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = resize_bilinear_align_corners(t, 24, 17)
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    _close(y.detach().permute(0, 2, 3, 1).numpy(), want, "resize")
    _close(t.grad.permute(0, 2, 3, 1).numpy(), want_grad, "resize gradient")
    # F.interpolate's float64 positions are not the JAX package's float32 ones
    plain = F.interpolate(t.detach(), size=(24, 17), mode="bilinear", align_corners=True)
    assert 1e-9 < np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() < 1e-5


# ------------------------------------------------------------ layers

C = 32  # wide enough for the reductions by 16


def _feat(rng, c=C, h=6, w=10, b=2):
    return rng.standard_normal((b, h, w, c))


def _ca(loader, m):
    loader.ca_layer(m, ())


def _se(loader, m):
    loader.conv(m.conv1, ("Conv_0",))
    loader.conv(m.conv2, ("Conv_1",))


LAYERS = {
    "squeeze_excitation": (lambda: jl.SqueezeAndExcitationBlock(C),
                           lambda: tl.SqueezeAndExcitationBlock(C), _se, 1),
    "channel_attention_ca": (lambda: jl.CALayer(C), lambda: tl.CALayer(C), _ca, 1),
    "pixel_attention_pa": (lambda: jl.CALayer(C, pix_att=True),
                           lambda: tl.CALayer(C, pix_att=True), _ca, 1),
    "contrast_aware": (lambda: jl.CALayer(C, contrast_aware=True),
                       lambda: tl.CALayer(C, contrast_aware=True), _ca, 1),
    "asca": (lambda: jl.AdaptivelyScaledCALayer(C), lambda: tl.AdaptivelyScaledCALayer(C),
             lambda loader, m: loader.asca(m, ()), 1),
    "up_shuffle": (lambda: jl.UpShuffle(8, 2), lambda: tl.UpShuffle(C, 8, 2),
                   lambda loader, m: loader.conv(m.conv, ("Conv_0",)), 1),
    "fse_module": (lambda: jl.FSEModule(12), lambda: tl.FSEModule(12 + 2 * C, 12),
                   lambda loader, m: loader.fse(m, ()), "fuse"),
    "diffnet_channel_attention": (
        lambda: jl.ChannelAttention(C), lambda: tl.ChannelAttention(C),
        lambda loader, m: (loader.dense(m.fc1, ("Dense_0",)),
                           loader.dense(m.fc2, ("Dense_1",))), 1),
    "attention_module": (lambda: jl.AttentionModule(12),
                         lambda: tl.AttentionModule(12 + 2 * C, 12),
                         lambda loader, m: loader.attention_module(m, ()), "fuse"),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    jmod, tmod, load, kind = LAYERS[name]
    rng = np.random.RandomState(sorted(LAYERS).index(name))
    if kind == "fuse":  # (high at half the size, two lows)
        args = (_feat(rng, 12, 3, 5), [_feat(rng), _feat(rng)])
    else:
        args = (_feat(rng),)
    compare(jmod(), args, tmod(), load, seed=1)


def test_pixel_shuffle_channel_order():
    """The JAX UpShuffle's NHWC shuffle, fed an identity convolution, is
    F.pixel_shuffle on NCHW: output channel c at offset (i, j) reads input
    channel c * r * r + i * r + j."""
    r, c = 2, 3
    x = np.random.RandomState(7).standard_normal((1, 4, 5, c * r * r))
    kernel = np.zeros((3, 3, c * r * r, c * r * r))
    kernel[1, 1] = np.eye(c * r * r)
    variables = {"params": {"Conv_0": {"kernel": kernel, "bias": np.zeros(c * r * r)}}}
    with jax.enable_x64(True):
        want = np.asarray(jl.UpShuffle(c, r).apply(variables, jnp.asarray(x)))
    got = F.elu(F.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), r))
    # the two ELUs round their exponentials apart by an ulp or so
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-14, atol=0)
    assert want[0, 0, 1, 2] == pytest.approx(np.exp(x[0, 0, 0, 2 * r * r + 1]) - 1
                                             if x[0, 0, 0, 2 * r * r + 1] < 0
                                             else x[0, 0, 0, 2 * r * r + 1])


def test_up_shuffle_starts_as_repeated_subkernels():
    """Sub-pixel init: each of the r * r outputs of a channel starts with the
    same kernel (kaiming-normal, fan-in), as the JAX init's jnp.repeat."""
    torch.manual_seed(0)
    m = tl.UpShuffle(64, 16, 2)
    w = m.conv.weight.detach()
    np.testing.assert_array_equal(w.numpy(), w[::4].repeat_interleave(4, dim=0).numpy())
    assert abs(w[::4].std().item() - np.sqrt(2.0 / (9 * 64))) < 0.05 * np.sqrt(2.0 / (9 * 64))


def test_attention_layers_start_as_flax():
    """flax's default init: lecun-normal kernels, zero biases."""
    torch.manual_seed(0)
    m = tl.CALayer(512)
    assert torch.count_nonzero(m.conv1.bias) == 0 and torch.count_nonzero(m.conv2.bias) == 0
    std = np.sqrt(1.0 / 512)
    assert abs(m.conv1.weight.std().item() - std) < 0.05 * std
    assert m.conv1.weight.abs().max().item() <= 2 * std / tl._TRUNC_STD


# ------------------------------------------------------------ decoders


def test_hr_depth_decoder_matches_jax():
    enc = (16, 16, 32, 64, 128)
    rng = np.random.RandomState(11)
    feats = [rng.standard_normal((2, 32 // 2**i, 64 // 2**i, c)) for i, c in enumerate(enc)]
    outs = compare(jdec.HRDepthDecoder(enc), (feats,),
                   tdec.HRDepthDecoder(enc), lambda loader, m: loader.hr_depth_decoder(m, ()))
    assert [o.shape[1:3] for o in outs] == [(64, 128), (32, 64), (16, 32), (8, 16)]


def test_diff_depth_decoder_matches_jax():
    w = 8
    enc = (64, w, 2 * w, 4 * w, 8 * w)
    rng = np.random.RandomState(12)
    h, wd = 64, 96

    def f(s, c):
        return rng.standard_normal((2, h // s, wd // s, c))

    feats = [f(2, 64), [f(4, 64)] + [f(4, w) for _ in range(3)], [f(8, 2 * w) for _ in range(3)],
             [f(16, 4 * w) for _ in range(2)], f(32, 8 * w)]
    outs = compare(jdec.DIFFDepthDecoder(enc), (feats,), tdec.DIFFDepthDecoder(enc),
                   lambda loader, m: loader.diff_depth_decoder(m, ()))
    assert [o.shape[1:3] for o in outs] == [(64, 96), (32, 48), (16, 24), (8, 12)]


# ------------------------------------------------------------ config


def test_diffnet_with_disentangle_raises_as_jax():
    kw = dict(name="mono_fm_joint_inpaint_disentangle", use_diffnet=True, depth_num_layers=18,
              disentangle_layers=(False, False, False, False, True), auto_res_weight=5e-3)
    from tripled_tpu.models.registry import build_model

    x = {"color": jnp.zeros((1, 3, 64, 96, 3)), "color_aug": jnp.zeros((1, 3, 64, 96, 3)),
         "K": jnp.tile(jnp.eye(4), (1, 1, 1)), "inv_K": jnp.tile(jnp.eye(4), (1, 1, 1)),
         "mask": jnp.ones((1, 64, 96, 1))}
    with pytest.raises(ValueError) as jax_error:
        jax.eval_shape(lambda: build_model(JaxModelConfig(**kw)).init(
            jax.random.PRNGKey(0), x, train=True))
    with pytest.raises(ValueError) as port_error:
        TripleDNet(ModelConfig(**kw))
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("option", [dict(depth_skip_type="asca"), dict(use_pfp=True),
                                    dict(use_hr_depth=True), dict(use_diffnet=True),
                                    dict(depth_use_shuffle=True), dict(color_skip_type="1x1"),
                                    dict(depth_disentangle_type="1x1")])
def test_bfloat16_with_an_architecture_option_waits(option):
    with pytest.raises(ValueError, match="later slice"):
        ModelConfig(compute_dtype="bfloat16", **option)
    cfg = ModelConfig(**option)
    assert cfg.architecture_options() == list(option)
    assert dataclasses.replace(cfg, compute_dtype="float32") == cfg
