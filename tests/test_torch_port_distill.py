"""The distillation parts of tripled_tpu_torch against the JAX package's, on
the CPU, with weights carried by `load_jax_variables`:

- `_distill_gs_loss` for every (use_normal, use_lab, use_mask) and
  `_distill_colorize_loss` for every (use_normal, use_mask), called as
  methods of each package's TripleDNet on the same disparity, frames and
  erase mask: the loss, its gradient into the disparity and into the head's
  parameters, and the head's BatchNorm statistics after the call;
- the surface normal, borders included (`jnp.gradient` against
  `torch.gradient`: central differences inside, one-sided at the edges);
- `BasicBlock(use_residual)`, with the 1-channel input that the grayscale
  head adds to its 32 channels by broadcasting, and the heads themselves;
- `Extractor` with additive per-stage `cond_features`, with every stage in
  the autograd graph and with only the first two, remat on and off.
The presets and their weight trees are in
`test_torch_port_distill_presets.py`.

Everything runs in float64 (jax x64). Tolerances, with the gaps seen:
- the two losses: rtol 5e-6, as every term that both packages reduce in
  float32 (`perceptional_loss` casts to float32 before its channel mean,
  and the mean over the pixels then sums float32 values in another order;
  seen 1.0e-6 for the grayscale loss, 5.8e-7 for the colorize loss);
- gradients, outputs and statistics: 1e-9 of the largest magnitude, as
  `test_torch_port_models.py` (seen 8.4e-13 in the losses' gradients,
  2.6e-13 in the conditioned extractor, 1.2e-14 in the heads);
- the surface normal: 1e-12 of its largest magnitude (seen 0).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tripled_tpu.config as jcfg
from test_torch_port_models import _close, _nchw, _nhwc, _random_variables
from test_torch_port_step import kernels_not_drawn
from tripled_tpu.data.transforms import make_erase_mask
from tripled_tpu.models import encoders as jenc
from tripled_tpu.models import net as jnet
from tripled_tpu.models import resnet as jresnet
from tripled_tpu.models.registry import build_model
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models import encoders as tenc
from tripled_tpu_torch.models.net import DistillHead, TripleDNet
from tripled_tpu_torch.models.resnet import BasicBlock
from tripled_tpu_torch.utils.jax_weights import _Loader, load_jax_variables

torch.set_num_threads(1)

B, H, W = 2, 32, 64
LOSS_RTOL = 5e-6
TOL = 1e-9

SMALL = dict(depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18, height=H,
             width=W, pose_height=H, pose_width=W, depth_dropout_rate=0.0)


def _distill_inputs(rng):
    color = rng.rand(B, 3, H, W, 3)
    mask = np.stack([make_erase_mask(rng, H, W, (8, 8), 4) for _ in range(B)]).astype(np.float64)
    disp0 = 0.05 + 0.9 * rng.rand(B, H // 2, W // 2, 1)
    return {"color": color, "mask": mask}, disp0


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _hold_distill(kw, jmethod, tmethod, head_name, rng):
    """One distillation loss in both packages, float64: value, gradients into
    the disparity and the head, and the head's statistics after the call."""
    inputs, disp0 = _distill_inputs(rng)
    with jax.enable_x64(True):
        jm = build_model(jcfg.ModelConfig(**kw))
        outputs = {"disps": [jnp.asarray(disp0)]}
        v = _random_variables(jm, inputs, outputs, dtype=np.float64, train=True, method=jmethod)

        def loss(params, d):
            return jm.apply({"params": params, "batch_stats": v["batch_stats"]}, inputs,
                            {"disps": [d]}, train=True, method=jmethod, mutable=["batch_stats"])

        want, mutated = jax.jit(loss)(v["params"], disp0)
        gparams, gdisp = jax.jit(jax.grad(lambda p, d: loss(p, d)[0], argnums=(0, 1)))(
            v["params"], disp0)

    with kernels_not_drawn():  # only the head, loaded, and its input reach the loss
        model = TripleDNet(ModelConfig(**kw)).double().train()
    head = getattr(model, head_name)
    load_jax_variables(head, v["params"][head_name], v["batch_stats"][head_name])
    tdisp = torch.from_numpy(disp0).requires_grad_()
    got = tmethod(model, _torch(inputs), {"disps": [tdisp]})
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _close(tdisp.grad.numpy(), gdisp, TOL)
    ref = DistillHead(head.block.conv1.in_channels, head.conv.out_channels,
                      head.block.use_residual).double()
    load_jax_variables(ref, gparams[head_name], mutated["batch_stats"][head_name])
    grads = dict(ref.named_parameters())
    for name, p in head.named_parameters():
        _close(p.grad.numpy(), grads[name].detach().numpy(), TOL)
    stats = dict(ref.named_buffers())
    for name, b in head.named_buffers():
        if "running" in name:
            _close(b.numpy(), stats[name].numpy(), TOL)


@pytest.mark.parametrize("use_mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("use_lab", [False, True], ids=["gray", "lab_l"])
@pytest.mark.parametrize("use_normal", [False, True], ids=["disp", "normal"])
def test_distill_gs_loss_matches_jax(use_normal, use_lab, use_mask, rng_np):
    kw = dict(SMALL, name="mono_fm_joint_inpaint_distill_gs", perception_weight=0.0,
              d2g_weight=5e-3, use_normal=use_normal, use_lab=use_lab, use_mask=use_mask)
    _hold_distill(kw, jnet.TripleDNet._distill_gs_loss, TripleDNet._distill_gs_loss,
                  "depth_to_gray", rng_np)


@pytest.mark.parametrize("use_mask", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("use_normal", [False, True], ids=["disp", "normal"])
def test_distill_colorize_loss_matches_jax(use_normal, use_mask, rng_np):
    kw = dict(SMALL, name="mono_fm_joint_inpaint_distill_colorize", perception_weight=0.0,
              colorize_weight=5e-3, use_normal=use_normal, use_mask=use_mask)
    _hold_distill(kw, jnet.TripleDNet._distill_colorize_loss,
                  TripleDNet._distill_colorize_loss, "colorize_net", rng_np)


@pytest.mark.parametrize("shape", [(B, H, W, 1), (1, 3, 5, 1)], ids=["frame", "tiny"])
def test_surface_normal_matches_jax(shape, rng_np):
    disp = 0.05 + 0.9 * rng_np.rand(*shape)
    kw = dict(SMALL, name="mono_fm_joint_inpaint_distill_gs", perception_weight=0.0,
              d2g_weight=5e-3, use_normal=True)
    with jax.enable_x64(True):
        jm = build_model(jcfg.ModelConfig(**kw))
        want = np.asarray(jm.apply({}, jnp.asarray(disp), method=jnet.TripleDNet._surface_normal))
    with kernels_not_drawn():  # the normal reads no parameter
        net = TripleDNet(ModelConfig(**kw))
    got = net._surface_normal(torch.from_numpy(disp)).numpy()
    assert got.shape == shape[:3] + (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # the borders are one-sided differences, not wrapped or zero-padded
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[:, :, -1], want[:, :, -1], rtol=0, atol=1e-12)


def _hold_module(jm, tm, x, load):
    """Train-mode forward, input gradient and statistics, float64."""
    with jax.enable_x64(True):
        v = _random_variables(jm, x, dtype=np.float64, train=True)
        apply = jax.jit(lambda a: jm.apply(v, a, train=True, mutable=["batch_stats"]))
        want, mutated = apply(x)
        w = np.random.RandomState(2).rand(*want.shape)
        jgrad = jax.grad(lambda a: (apply(a)[0] * w).sum())(x)
    tm = tm.double()
    load(tm, v["params"], v["batch_stats"])
    tx = _nchw(x).requires_grad_()
    got = tm(tx)
    (got * _nchw(w)).sum().backward()
    _close(_nhwc(got), want, TOL)
    _close(_nhwc(tx.grad), jgrad, TOL)
    return mutated


def _load_block(block, params, stats):
    loader = _Loader(params, stats)
    loader.block(block, ())
    assert not params or all(not v for v in loader.params.values())


@pytest.mark.parametrize("cin,use_residual", [(1, True), (1, False), (32, True), (32, False)])
def test_basic_block_use_residual_matches_jax(cin, use_residual, rng_np):
    """With no downsample the residual is the input: a 1-channel input is
    added to all 32 output channels by broadcasting, in both packages."""
    x = rng_np.randn(B, 16, 24, cin)
    mutated = _hold_module(jresnet.BasicBlock(32, use_residual=use_residual),
                           BasicBlock(cin, 32, use_residual=use_residual), x, _load_block)
    assert set(mutated["batch_stats"]) == {"BatchNorm_0", "BatchNorm_1"}


@pytest.mark.parametrize("cin,cout,use_residual", [(1, 1, True), (2, 1, False), (2, 2, False),
                                                   (4, 2, False)])
def test_distill_head_matches_jax(cin, cout, use_residual, rng_np):
    x = rng_np.rand(B, 16, 24, cin)
    th = DistillHead(cin, cout, use_residual)

    class NHWC(torch.nn.Module):  # the head's NHWC interface, seen as NCHW
        def __init__(self):
            super().__init__()
            self.head = th

        def forward(self, t):
            return self.head(t.movedim(1, -1)).movedim(-1, 1)

    _hold_module(jnet._DistillHead(cout, use_residual=use_residual), NHWC(), x,
                 lambda m, p, s: load_jax_variables(m.head, p, s))


@functools.lru_cache(maxsize=None)
def _extractor_reference():
    """The JAX extractor with conditioning on seeded inputs: inputs,
    weights, variables, features, statistics, the gradients of the first k
    features (k = 5 and 2) and the features without conditioning."""
    rng = np.random.RandomState(1024)
    x = rng.rand(B, H, W, 3)
    cond = [rng.randn(B, H // s, W // s, c)
            for s, c in zip((2, 4, 8, 16, 32), (64, 64, 128, 256, 512))]
    with jax.enable_x64(True):
        jm = jenc.Extractor(18)
        v = _random_variables(jm, x, cond, dtype=np.float64, train=True)
        # jitted: one compile each, where op-by-op dispatch compiles every op
        fwd = jax.jit(lambda a, cs: jm.apply(v, a, cs, train=True, mutable=["batch_stats"]))
        feats, mutated = fwd(x, cond)
        _, pullback = jax.vjp(lambda a, cs: fwd(a, cs)[0], x, cond)
        weights = [rng.rand(*f.shape) for f in feats]
        grads = {k: pullback([w if i < k else np.zeros_like(w) for i, w in enumerate(weights)])
                 for k in (5, 2)}
        plain = jax.jit(lambda a: jm.apply(v, a, train=True, mutable=["batch_stats"])[0])(x)
    return x, cond, weights, v, feats, mutated, grads, plain


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("graph_stages", [5, 2])
def test_extractor_cond_features_match_jax(graph_stages, remat):
    """Each stage's stored output is its sum with its conditioning feature,
    in the stages with an autograd graph and in those without."""
    x, cond, weights, v, feats, mutated, grads, plain = _extractor_reference()
    gx, gcond = grads[graph_stages]
    tm = tenc.Extractor(18, remat=remat).double()
    load_jax_variables(tm, v["params"], v["batch_stats"])
    tx = _nchw(x).requires_grad_()
    tcond = [_nchw(c).requires_grad_() for c in cond]
    tfeats = tm(tx, graph_stages, cond_features=tcond)
    assert [f.requires_grad for f in tfeats] == [i < graph_stages for i in range(5)]
    sum((f * _nchw(w)).sum() for f, w in list(zip(tfeats, weights))[:graph_stages]).backward()
    for f, jf in zip(tfeats, feats):
        _close(_nhwc(f), jf, TOL)
    _close(_nhwc(tx.grad), gx, TOL)
    for i, (c, jg) in enumerate(zip(tcond, gcond)):
        if i < graph_stages:
            _close(_nhwc(c.grad), jg, TOL)
        else:
            assert c.grad is None and not np.asarray(jg).any()
    ref = tenc.Extractor(18).double()
    load_jax_variables(ref, v["params"], jax.tree_util.tree_map(np.asarray,
                                                                 mutated["batch_stats"]))
    for (n, got), (_, want) in zip(tm.named_buffers(), ref.named_buffers()):
        if "running" in n:
            _close(got.numpy(), want.numpy(), TOL)
    # no conditioning: the features of the plain extractor
    tm0 = tenc.Extractor(18, remat=remat).double()
    load_jax_variables(tm0, v["params"], v["batch_stats"])
    for f, jf in zip(tm0(_nchw(x), graph_stages), plain):
        _close(_nhwc(f), jf, TOL)
