"""`mono_fm_joint_im_rot`: the extractor on a rotated 48-pixel crop of the
target with `rot_head` and `ssl_rot_loss`, and the crop-matched perceptual
term. One step in float64 against the JAX step, as
`test_torch_port_pretext_steps.py` says (TOL_F64), with the same fixed
crop offset and rotation labels in both packages, cut to one source frame
and scale 0 (the JAX step's trace and compile grow with them; the
rotation pretext reads the target alone).

The JAX step runs on a 2-device mesh (`make_mesh(jax.devices()[:2])`, the
batch of 2 split in two), where it reduces BatchNorm's statistics and the
rotation pretext's softmax over the batch across the devices: the function
the single-device step computes (`tests/test_parallel.py`). One compile
holds two port steps from the same weights: the port's 1-process step on
the batch, and its step on 2 gloo ranks of one row each
(`tests/torch_port_ddp_worker.py`, started beside the JAX compile), whose
batch softmax gathers the ranks' logits and labels (`parallel.dist.gather_rows`)
and whose labels are the fixed ones, each rank keeping its row.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_pretext_steps import (
    LABELS,
    OFFSET,
    _jax_crop,
    _jax_rotate,
    expected_keys,
    pretext_inputs,
    pretext_kwargs,
)
from test_torch_port_step import check_against_jax, run_both
from torch_port_ddp_worker import spawn_ranks
from tripled_tpu.models import aux_nets as jax_aux
from tripled_tpu.parallel.mesh import make_mesh
from tripled_tpu_torch.models import aux_nets

torch.set_num_threads(1)

NAME = "mono_fm_joint_im_rot"
# the rotation head's bias meets a softmax over the batch, which cancels
# it: its gradient is zero but for rounding
ZERO = ("rot_head.bias",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh step, the port's 1-process step and rank 0's result."""
    tmp = tmp_path_factory.mktemp("im_rot")
    kwargs = pretext_kwargs(NAME, frame_ids=(0, 1), scales=(0,))
    inputs = pretext_inputs(sources=1)
    np.savez(tmp / "inputs.npz", **inputs)
    waits = []

    def start_ranks(model):
        torch.save(model.state_dict(), tmp / "state.pt")
        spec = {"cases": [dict(kwargs=kwargs, dtype="float64", state=str(tmp / "state.pt"),
                               inputs=str(tmp / "inputs.npz"), dir=str(tmp), steps=1, seed=0,
                               optim={"warmup_iters": 2},
                               fixed_pretext={"offset": OFFSET, "labels": LABELS})]}
        waits.append(spawn_ranks(spec, tmp))

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_aux, "random_crop", _jax_crop)
    mp.setattr(jax_aux, "random_rotate_batch", _jax_rotate)
    mp.setattr(aux_nets, "draw_pretext", lambda generator, batch, height, width, size:
               (*OFFSET, torch.tensor(LABELS[:batch])))
    try:
        with jax.enable_x64(True):
            jm, tm, model, ref, jgrads = run_both(kwargs, dtype=np.float64, inputs=inputs,
                                                  mesh=make_mesh(jax.devices()[:2]),
                                                  before_jax=start_ranks)
    finally:
        mp.undo()
        for wait in waits:
            wait()
    rank0 = json.loads((tmp / "rank0.json").read_text())
    rank0.update(torch.load(tmp / "rank0.pt"))
    os.remove(tmp / "rank0.pt")
    rank1 = json.loads((tmp / "rank1.json").read_text())
    return jm, tm, model, ref, jgrads, rank0, rank1


def test_im_rot_step_float64_matches_jax(runs):
    jm, tm, model, ref, jgrads, _, _ = runs
    assert list(tm) == expected_keys(NAME, scales=(0,))
    check_against_jax(jm, tm, model, ref, jgrads, automask=False, tol=TOL_F64, zero_grads=ZERO)
    assert tm["ssl_rot_loss"] > 0 and tm["min_perceptional_loss"] > 0


def test_im_rot_two_ranks_match_the_jax_mesh_step(runs):
    jm, _, model, ref, jgrads, rank0, rank1 = runs
    assert rank0["metrics"] == rank1["metrics"]
    assert rank0["ranks_equal"] and rank1["ranks_equal"] and rank0["count"] == 1
    (metrics,) = rank0["metrics"]
    assert list(metrics) == expected_keys(NAME, scales=(0,))
    ranked = copy.deepcopy(model)
    ranked.load_state_dict(rank0["state"])
    for k, p in ranked.named_parameters():
        p.grad = rank0["grads"][k]
    check_against_jax(jm, metrics, ranked, ref, jgrads, automask=False, tol=TOL_F64,
                      zero_grads=ZERO)
