"""The distillation presets of tripled_tpu_torch against the JAX package's
registry, and their weight trees, on the CPU (no step runs here):

- `canonicalize`, field by field, for the 11 names of the slices before
  the pretext presets (`Baseline` included) without the perceptual term
  (the two presets without an extractor) and without the image
  reconstruction;
- `load_jax_variables` on each distillation preset's JAX tree, remat on
  and off: the networks each preset builds, every tensor written, nothing
  left over; the separate encoders keep their plain `ResNetFeatures_0`
  name under remat, as the JAX package does not rematerialise them.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import tripled_tpu.config as jcfg
from test_torch_port_distill import SMALL, B, _distill_inputs
from test_torch_port_models import _random_variables
from test_torch_port_step import kernels_not_drawn
from tripled_tpu.models.registry import _PRESETS, build_model
from tripled_tpu_torch import presets
from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

# the names of the slices up to the distillation presets; the pretext
# presets are held in `test_torch_port_pretext_presets.py`
NAMES = sorted(set(presets.PRESETS) - set(presets.PRETEXT_PRESETS))


def test_the_port_knows_eleven_presets():
    assert len(NAMES) == 11 and "Baseline" in NAMES
    assert set(NAMES) <= set(_PRESETS)


# `test_torch_port_flagship_modules.py` holds every name with the
# perceptual term and the image reconstruction on
@pytest.mark.parametrize("base", [
    dict(perception_weight=0.0, auto_res_weight=5e-3, colorize_weight=5e-3),
    dict(perception_weight=1e-3, img_reconstruct_weight=0.0, auto_res_weight=5e-3),
], ids=["no_percep", "no_image_decoder"])
@pytest.mark.parametrize("name", NAMES)
def test_canonicalize_matches_jax(name, base):
    got = presets.canonicalize(ModelConfig(name=name, **base))
    want = _PRESETS[name](jcfg.ModelConfig(name=name, **base))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


DISTILL = {
    "gs": dict(name="mono_fm_joint_inpaint_distill_gs", perception_weight=0.0, d2g_weight=5e-3,
               use_lab=True),
    "colorize": dict(name="mono_fm_joint_inpaint_distill_colorize", perception_weight=0.0,
                     colorize_weight=5e-3, use_normal=True),
    "disentangle_colorize": dict(name="mono_fm_joint_inpaint_disentangle_distill_colorize",
                                 auto_res_weight=5e-3, colorize_weight=5e-3),
    "sep_colorize": dict(name="mono_fm_joint_inpaint_disentangle_distill_sep_colorize",
                         auto_res_weight=5e-3, colorize_weight=5e-3, colorize_num_layers=50),
    "sep_inpaint": dict(name="mono_fm_joint_inpaint_disentangle_distill_sep_inpaint",
                        auto_res_weight=5e-3, inpaint_weight=5e-3, inpaint_num_layers=18),
}

# the modules each preset has beyond the depth and pose networks
MODULES = {
    "gs": {"depth_to_gray"},
    "colorize": {"colorize_net"},
    "disentangle_colorize": {"extractor", "image_decoder", "colorize_net"},
    "sep_colorize": {"extractor", "image_decoder", "colorize_encoder", "colorize_decoder"},
    "sep_inpaint": {"extractor", "image_decoder", "inpaint_encoder", "inpaint_decoder"},
}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("preset", sorted(DISTILL))
def test_load_jax_variables_fills_each_distill_preset(preset, remat, rng_np):
    kw = dict(SMALL, **DISTILL[preset], remat=remat)
    inputs, _ = _distill_inputs(rng_np)
    inputs = dict(inputs, color_aug=inputs["color"], K=np.tile(np.eye(4), (B, 1, 1)),
                  inv_K=np.tile(np.eye(4), (B, 1, 1)))
    inputs = jax.tree_util.tree_map(lambda a: a.astype(np.float32), inputs)
    jm = build_model(jcfg.ModelConfig(**kw))
    v = _random_variables(jm, inputs, train=True)
    with kernels_not_drawn():  # the load overwrites every parameter
        tm = TripleDNet(ModelConfig(**kw))
    base = {"depth_encoder", "depth_decoder", "pose_encoder", "pose_decoder"}
    assert set(v["params"]) == base | MODULES[preset]
    assert {n for n, _ in tm.named_children()} == base | MODULES[preset]
    # the separate encoders are never rematerialised, the trunk's are
    for name in ("colorize_encoder", "inpaint_encoder"):
        if name in v["params"]:
            assert list(v["params"][name]) == ["ResNetFeatures_0"]
    if remat and "extractor" in v["params"]:
        assert list(v["params"]["extractor"]) == ["CheckpointResNetFeatures_0"]
    load_jax_variables(tm, v["params"], v["batch_stats"])
