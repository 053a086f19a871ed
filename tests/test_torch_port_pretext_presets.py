"""The six pretext presets of tripled_tpu_torch against the JAX package's
registry, weight trees and eval outputs, on the CPU (no training step of
JAX runs here):

- the port knows every name of the JAX registry; `canonicalize` field by
  field at each pretext preset's shipped values, `build_model`'s module,
  and bf16 refused for the six;
- `load_jax_variables` on each preset's JAX tree, remat on and off: the
  modules each builds (`rot_head`, `pose_map_cls`, the standalone
  `encoder`, `decoder`, `head`), every tensor written, nothing left over;
  and with the plain tree, eval outputs in float64 against the JAX
  package's with the carried weights: the disparities [s0..s3] of the three
  TripleDNet presets, the reconstructions [s0..s3] of the autoencoder and
  inpainter, and RotNet's logits and labels (RotNet draws its crop and
  rotations in eval too; both packages take the fixed draws of
  `test_torch_port_pretext_steps.py`), within 1e-10.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tripled_tpu.config as jcfg
from test_torch_port_pretext_steps import fixed_draws, pretext_inputs, pretext_kwargs  # noqa: F401
from test_torch_port_step import _random_variables, kernels_not_drawn
from tripled_tpu.models.registry import _PRESETS, build_model as jax_build_model
from tripled_tpu_torch import presets
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.presets import PRETEXT_PRESETS
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

MODULES = {
    "mono_fm_joint_im_rot": {"extractor", "rot_head"},
    "mono_fm_joint_inpaint_map_pose": {"pose_map_cls"},
    "mono_fm_joint_equivariant_inpaint": {"extractor", "image_decoder"},
    "autoencoder": {"encoder", "decoder"},
    "inpainter": {"encoder", "decoder"},
    "rotnet": {"encoder", "head"},
}
TRUNK = {"depth_encoder", "depth_decoder", "pose_encoder", "pose_decoder"}
MODULE_TYPES = {"autoencoder": "Autoencoder", "inpainter": "Autoencoder", "rotnet": "RotNet"}


def test_the_port_knows_every_preset():
    assert set(presets.PRESETS) == set(_PRESETS)
    assert set(PRETEXT_PRESETS) == set(MODULES)


@pytest.mark.parametrize("name", PRETEXT_PRESETS)
def test_canonicalize_and_build_match_jax(name):
    kw = pretext_kwargs(name)
    got = presets.canonicalize(ModelConfig(**kw))
    want = _PRESETS[name](jcfg.ModelConfig(**kw))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    model = presets.build_model(ModelConfig(**kw))
    assert type(model).__name__ == MODULE_TYPES.get(name, "TripleDNet")
    assert type(model).__name__ == type(jax_build_model(jcfg.ModelConfig(**kw))).__name__
    assert getattr(model, "masked", False) == (name == "inpainter")
    with pytest.raises(ValueError, match="later slice"):
        ModelConfig(**dict(kw, compute_dtype="bfloat16"))


def jax_tree(name, remat):
    """The preset's small kwargs, float64 inputs, JAX module and float64
    variables."""
    kw = pretext_kwargs(name, remat=remat)
    inputs = pretext_inputs(np.float64)
    jm = jax_build_model(jcfg.ModelConfig(**kw))
    params, stats = _random_variables(jm, inputs, np.float64)
    return kw, inputs, jm, params, stats


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("name", PRETEXT_PRESETS)
def test_load_jax_variables_and_eval_outputs(name, remat, fixed_draws):  # noqa: F811
    kw, inputs, jm, params, stats = jax_tree(name, remat)
    standalone = name in MODULE_TYPES
    assert set(params) == (set() if standalone else TRUNK) | MODULES[name]
    with kernels_not_drawn():  # the load overwrites every parameter
        model = presets.build_model(ModelConfig(**kw)).double()
    assert {n for n, _ in model.named_children()} == set(params)
    # the standalone modules never rematerialise in the JAX package
    enc = "encoder" if standalone else "extractor"
    if enc in params:
        want = "CheckpointResNetFeatures_0" if remat and not standalone else "ResNetFeatures_0"
        assert list(params[enc]) == [want]
    load_jax_variables(model, params, stats)
    for head in ("rot_head", "pose_map_cls", "head"):
        if head in params:
            np.testing.assert_array_equal(getattr(model, head).weight.detach().numpy(),
                                          params[head]["kernel"].T)
    if remat:
        return
    with jax.enable_x64(True):
        rngs = {"crop": jax.random.PRNGKey(5), "rotation": jax.random.PRNGKey(6)}
        want = jax.jit(lambda v, x: jm.apply(v, x, train=False, rngs=rngs))(
            {"params": params, "batch_stats": stats}, inputs)
        want = jax.tree_util.tree_map(np.asarray, want)
    model.eval()
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    if name == "rotnet":
        np.testing.assert_array_equal(got["rot_gt"].numpy(), np.asarray(want["rot_gt"]))
        np.testing.assert_allclose(got["rot_predicts"].numpy(), np.asarray(want["rot_predicts"]),
                                   rtol=1e-10, atol=1e-12)
        return
    assert len(got) == len(want) == 4
    for s, (g, w) in enumerate(zip(got, want)):
        h = 64 if standalone else 32
        assert g.shape == w.shape == (2, h >> s, (5 * h // 2) >> s, 3 if standalone else 1), s
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-12)
