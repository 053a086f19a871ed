"""One float64 training step of each pretext preset in tripled_tpu_torch
against the JAX package's step on the CPU, through `run_both` /
`check_against_jax` (`test_torch_port_step.py`), with TOL_F64
(`test_torch_port_flagship_f64.py`): every loss_dict entry, each tensor's
gradient, the parameters after the Adam update and the BatchNorm
statistics. This file holds `mono_fm_joint_inpaint_map_pose` and the
helpers of the other step files, one step of a JAX compile each:
- `test_torch_port_im_rot_steps.py`: `mono_fm_joint_im_rot`;
- `test_torch_port_equivariant_steps.py`: `mono_fm_joint_equivariant_inpaint`;
- `test_torch_port_standalone_steps.py`: `autoencoder`, `inpainter`, `rotnet`.

Every step is the small flagship's (R18 everywhere, 64x160, the pose net
at 32x96, batch 2, 6 erased 8x8 squares per sample, decoder dropout off,
automask off) with the preset's name, its shipped config's values
(`configs/cfg_kitti_*.py`), no stage split, and a 48-pixel pretext crop (its
last extractor stage 2x2: at 1x1, BatchNorm over two values per channel
makes the gradient too ill-conditioned for TOL_F64).
The map-pose inputs carry the motion masks of the frames
(`data/transforms.motion_mask`) and labels drawn over the shipped alphas;
its step, the autoencoder's and the inpainter's run at 64x96 (the pose
net at 32x64), which they can: they take no crop; the map-pose step at
scale 0 alone (its terms read the pose network's features of each pair,
not the scales).

The crop offset and rotation labels are fixed in both packages: the port's
`aux_nets.draw_pretext` and the JAX package's `random_crop` and
`random_rotate_batch` are replaced, in the test only, by the same draws
(offset (13, 71), labels (1, 3)); the JAX replacement keeps the JAX
selection of the rotated copies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_flagship import flagship_inputs, flagship_kwargs
from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import check_against_jax, run_both
from tripled_tpu.models import aux_nets as jax_aux
from tripled_tpu_torch.data.transforms import motion_mask
from tripled_tpu_torch.models import aux_nets

torch.set_num_threads(1)

OFFSET = (13, 71)
LABELS = (1, 3)
ALPHAS = (0.1, 0.4, 0.7, 1.0)

SHIPPED = {
    "mono_fm_joint_im_rot": dict(perception_weight=1e-3, pretext_label_size=4,
                                 pretext_weight=1.0),
    "mono_fm_joint_inpaint_map_pose": dict(perception_weight=0.0, map_output=16,
                                           map_pose_weight=0.5),
    "mono_fm_joint_equivariant_inpaint": dict(perception_weight=1e-3, equivariant_weight=1e-3),
    "autoencoder": {},
    "inpainter": {},
    "rotnet": dict(pretext_label_size=4, pretext_weight=1.0),
}


def pretext_kwargs(name, **extra):
    kw = dict(flagship_kwargs(automask=False), name=name, auto_res_weight=0.0,
              disentangle_layers=(False, False, False, False, False), pretext_resize=48)
    return dict(kw, **SHIPPED[name], **extra)


def pretext_inputs(dtype=np.float64, erase_border=False, **size):
    """The small flagship's inputs, with motion masks and map params; with
    `erase_border`, a 2-pixel border of the inpaint mask erased too; `size`,
    flagship_inputs' h, w and sources where a step file cuts them."""
    inputs = flagship_inputs(dtype, **size)
    if erase_border:
        m = inputs["mask"]
        m[:, :2], m[:, -2:], m[:, :, :2], m[:, :, -2:] = 0, 0, 0, 0
    color = inputs["color"]
    b, f = color.shape[:2]
    inputs["map_mask"] = np.stack([
        np.stack([motion_mask(color[s, 0].astype(np.float32), color[s, i].astype(np.float32))
                  for i in range(1, f)]) for s in range(b)]).astype(dtype)
    labels = np.random.RandomState(7).randint(0, len(ALPHAS) ** 2, (b, f - 1))
    inputs["map_params"] = np.stack(
        [labels, np.take(ALPHAS, labels // 4), np.take(ALPHAS, labels % 4)], -1).astype(dtype)
    return inputs


def _jax_crop(rng, images, size):
    ri, rj = OFFSET
    return jax.lax.dynamic_slice(images, (0, ri, rj, 0), images.shape[:1] + (size, size)
                                 + images.shape[3:]), (ri, rj)


def _jax_rotate(rng, images):
    labels = jnp.asarray(LABELS[:images.shape[0]])
    rots = jnp.stack([jnp.rot90(images, k, axes=(1, 2)) for k in range(4)], axis=0)
    sel = jax.nn.one_hot(labels, 4, dtype=images.dtype)
    return jnp.einsum("kbhwc,bk->bhwc", rots, sel), labels


@pytest.fixture
def fixed_draws(monkeypatch):
    """The same crop offset and labels in both packages."""
    monkeypatch.setattr(jax_aux, "random_crop", _jax_crop)
    monkeypatch.setattr(jax_aux, "random_rotate_batch", _jax_rotate)
    monkeypatch.setattr(aux_nets, "draw_pretext",
                        lambda generator, batch, height, width, size:
                        (*OFFSET, torch.tensor(LABELS[:batch])))


def expected_keys(name, scales=range(4)):
    """The port's loss keys in order, then the total and the norm."""
    ext = [f"feature_regularization_loss/{i}" for i in range(5)]
    keys = {
        "mono_fm_joint_im_rot": ext + ["min_perceptional_loss", "ssl_rot_loss"]
        + [f"{k}/{s}" for s in scales for k in ("min_reconstruct_loss", "smooth_loss")],
        "mono_fm_joint_inpaint_map_pose":
            [f"{k}/{s}" for s in scales for k in ("min_reconstruct_loss", "smooth_loss")]
            + ["map_pose_loss/1", "map_pose_loss/2"],
        "mono_fm_joint_equivariant_inpaint": ext + [
            f"{k}/{s}" for s in scales for k in ("img_reconstruct_loss", "min_reconstruct_loss",
                                                 "min_equivariant_loss", "smooth_loss")],
        "autoencoder": [f"smooth_loss/{i}" for i in range(5)]
        + [f"min_reconstruct_loss/{s}" for s in range(4)],
        "rotnet": [f"smooth_loss/{i}" for i in range(5)] + ["ssl_rot_loss"],
    }
    keys["inpainter"] = keys["autoencoder"]
    return keys[name] + ["loss", "grad_norm"]


def hold_f64(name, inputs=None, **extra):
    with jax.enable_x64(True):
        jm, tm, *rest = run_both(pretext_kwargs(name, **extra), dtype=np.float64,
                                 inputs=pretext_inputs() if inputs is None else inputs)
    assert list(tm) == expected_keys(name, extra.get("scales", range(4)))
    # the rotation head's bias meets a softmax over the batch, which
    # cancels it: its gradient is zero but for rounding
    zero = {"mono_fm_joint_im_rot": ("rot_head.bias",), "rotnet": ("head.bias",)}
    check_against_jax(jm, tm, *rest, automask=False, tol=TOL_F64, zero_grads=zero.get(name, ()))
    return tm


def test_map_pose_step_float64_matches_jax(fixed_draws):
    # at 64x96 and scale 0 with both source frames (a map-pose term each):
    # no crop here
    tm = hold_f64("mono_fm_joint_inpaint_map_pose", inputs=pretext_inputs(h=64, w=96),
                  height=64, width=96, pose_width=64, scales=(0,))
    assert tm["map_pose_loss/1"] > 0 and tm["map_pose_loss/2"] > 0
