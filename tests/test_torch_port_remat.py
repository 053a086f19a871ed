"""`remat=True` in tripled_tpu_torch is a trade of memory for arithmetic
that changes no number: on the CPU, one training step with remat on and one
with it off, from the same weights, batch and dropout generator, give bit
for bit the same losses, gradients, BatchNorm running statistics and batch
counts, parameters and Adam moments after the update, and leave the
generator in the same state.

Small models (R18 everywhere, 64x128, batch 2): mono_fm (frozen extractor)
and the flagship TripleDNet (joint extractor, ImageDecoder, ColorDecoder,
inpaint mask), with the decoder's dropout at 0.5 drawn from a seeded
torch.Generator, in float32 and in bfloat16. The recompute runs the
forward again in training mode, so these also hold that BatchNorm moves
its statistics once per call, not again in the recompute, and that the
dropout masks are not drawn again. No JAX here: the step against the JAX
package's is held in the other test_torch_port_* files.
"""

import dataclasses

import pytest
import torch

from tripled_tpu_torch.config import ModelConfig, OptimConfig
from tripled_tpu_torch.models import layers
from tripled_tpu_torch.models.layers import BatchNorm
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.train.step import make_train_step
from tripled_tpu_torch.utils.inputs import random_train_inputs

torch.set_num_threads(1)

SMALL = dict(depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18, height=64,
             width=128, pose_height=64, pose_width=128, depth_dropout_rate=0.5)
CONFIGS = {
    "mono_fm": ModelConfig(name="mono_fm", **SMALL),
    "flagship": ModelConfig(name="mono_fm_joint_inpaint_disentangle", auto_res_weight=5e-3,
                            disentangle_layers=(False, False, False, False, True), **SMALL),
}
# checkpointed regions per step: the depth encoder, the pose encoder on each
# of the two frame pairs, the depth decoder, and for the flagship the
# extractor on the target and on each source frame, the ImageDecoder and
# the ColorDecoder. The frozen extractor (mono_fm, no graph) and the pose
# decoder are not wrapped.
REGIONS = {"mono_fm": 4, "flagship": 9}


def _step(cfg, remat, dtype):
    cfg = dataclasses.replace(cfg, remat=remat, compute_dtype=dtype)
    state = create_train_state(cfg, OptimConfig(warmup_iters=2), 100, seed=1, device="cpu")
    step = make_train_step(state.model, state.optimizer)
    batch = random_train_inputs(2, cfg.height, cfg.width, seed=0, erase_count=4,
                                erase_shape=(8, 8), device="cpu")
    gen = torch.Generator().manual_seed(3)
    metrics = step(batch, gen)
    grads = {n: p.grad for n, p in state.model.named_parameters() if p.grad is not None}
    return dict(metrics=metrics, grads=grads, state=state.model.state_dict(),
                optimizer=state.optimizer.state_dict(), generator=gen.get_state(),
                model=state.model)


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


@pytest.fixture(scope="module", params=[(n, d) for n in CONFIGS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def runs(request):
    name, dtype = request.param
    calls = []
    real = layers.checkpoint

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    off = _step(CONFIGS[name], False, dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "checkpoint", counting)
        on = _step(CONFIGS[name], True, dtype)
    return dict(name=name, off=off, on=on, regions=len(calls))


def test_losses_are_bit_equal(runs):
    assert list(runs["on"]["metrics"]) == list(runs["off"]["metrics"])
    _assert_same(runs["on"]["metrics"], runs["off"]["metrics"])
    assert all(torch.isfinite(v) for v in runs["on"]["metrics"].values())


def test_gradients_are_bit_equal(runs):
    _assert_same(runs["on"]["grads"], runs["off"]["grads"])
    assert len(runs["on"]["grads"]) > 0


def test_parameters_statistics_and_adam_are_bit_equal(runs):
    _assert_same(runs["on"]["state"], runs["off"]["state"])
    _assert_same(runs["on"]["optimizer"], runs["off"]["optimizer"])


def test_dropout_draws_once(runs):
    assert torch.equal(runs["on"]["generator"], runs["off"]["generator"])


def test_statistics_move_once_per_call(runs):
    # the depth encoder runs once per step: each of its BatchNorm layers
    # counts one batch, remat or not
    model = runs["on"]["model"]
    counts = {int(m.num_batches_tracked) for m in model.depth_encoder.modules()
              if isinstance(m, BatchNorm)}
    assert counts == {1}


def test_the_regions_that_remat_wraps(runs):
    assert runs["regions"] == REGIONS[runs["name"]]


def test_recompute_leaves_running_statistics_alone():
    bn = BatchNorm(4).train()
    x = torch.randn(2, 4, 5, 6, requires_grad=True)
    before = (bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone())
    y = bn(x)
    after = (bn.running_mean.clone(), bn.running_var.clone(), bn.num_batches_tracked.clone())
    assert not torch.equal(after[0], before[0]) and int(after[2]) == 1
    with layers._recompute_context():
        assert layers.recomputing()
        y2 = bn(x)
    assert not layers.recomputing()
    assert torch.equal(y, y2)
    _assert_same((bn.running_mean, bn.running_var, bn.num_batches_tracked), after)
