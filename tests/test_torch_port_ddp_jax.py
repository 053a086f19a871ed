"""tripled_tpu_torch's data parallelism against the JAX package's, on the
CPU, with a rank of the port standing for a JAX process:

- a `mono_baseline` step (R18 depth and pose, 64x96, one source frame,
  dropout and automask off) on 2 gloo ranks of global batch 4 as 2x2,
  against the JAX step on a 2-device mesh (`make_mesh(jax.devices()[:2])`)
  from the same weights, in float64 within TOL_F64
  (`test_torch_port_flagship_f64.py`): every loss term, the gradient
  norm, each tensor's gradient, the parameters after the update and the
  BatchNorm statistics, which the JAX step reduces over the global batch;
- `BatchLoader(num_shards=2)`: each shard's indices and batches equal to
  the JAX loader's, with `drop_last` on and off;
- the 2-rank `DepthEvaluator` (`range(rank, n, 2)`, rows gathered to both
  ranks) against the JAX evaluator's sequential result, within the eval
  tests' RTOL (`test_torch_port_eval.py`), both ranks alike.

The ranks run `tests/torch_port_ddp_worker.py` and import no JAX.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_eval import RTOL
from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import (
    STEPS_PER_EPOCH,
    _port_model,
    _random_variables,
    check_against_jax,
    port_template,
    release_jax_memory,
)
from torch_port_ddp_worker import spawn_ranks
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.config import OptimConfig as JaxOptimConfig
from tripled_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from tripled_tpu.eval.evaluator import DepthEvaluator as JaxDepthEvaluator
from tripled_tpu.models.registry import build_model
from tripled_tpu.parallel.mesh import make_mesh, replicated_sharding, shard_batch
from tripled_tpu.train.optim import make_optimizer
from tripled_tpu.train.state import TrainState
from tripled_tpu.train.step import make_train_step as jax_train_step
from tripled_tpu_torch.data.pipeline import BatchLoader

torch.set_num_threads(1)

B, H, W = 4, 64, 96
KWARGS = dict(name="mono_baseline", depth_num_layers=18, pose_num_layers=18, height=H, width=W,
              pose_height=H, pose_width=W, frame_ids=(0, 1), depth_dropout_rate=0.0,
              automask=False)


def step_inputs():
    rng = np.random.RandomState(0)
    K = np.tile(np.eye(4), (B, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    return {"color": rng.rand(B, 2, H, W, 3), "color_aug": rng.rand(B, 2, H, W, 3), "K": K,
            "inv_K": np.linalg.inv(K)}


class EvalData:
    """The JAX multi-process test's evaluation set: 10 images at 32x64 and
    ground truths at 40x80."""

    def __init__(self, n=10):
        rng = np.random.RandomState(0)
        self.imgs = rng.rand(n, 1, 32, 64, 3).astype(np.float32)
        self.gt_depths = [rng.rand(40, 80).astype(np.float64) * 30 + 1 for _ in range(n)]

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, rng):
        return {"color": self.imgs[i]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_jax")
    with jax.enable_x64(True):
        inputs = step_inputs()
        jmodel = build_model(JaxModelConfig(**KWARGS))
        params, stats = _random_variables(jmodel, inputs, np.float64)
        template = port_template(KWARGS, torch.float64)
        start = _port_model(KWARGS, torch.float64, params, stats, template)
        torch.save(start.state_dict(), tmp / "state.pt")
        np.savez(tmp / "inputs.npz", **inputs)
        data = EvalData()
        np.savez(tmp / "eval.npz", imgs=data.imgs, gt=np.stack(data.gt_depths))
        spec = {"cases": [dict(kwargs=KWARGS, dtype="float64", state=str(tmp / "state.pt"),
                               inputs=str(tmp / "inputs.npz"), dir=str(tmp), steps=1, seed=0,
                               optim={"warmup_iters": 2})],
                "eval": dict(inputs=str(tmp / "eval.npz"), dir=str(tmp))}
        wait = spawn_ranks(spec, tmp)
        try:
            # the JAX step on a 2-device mesh while the ranks run
            tx, _ = make_optimizer(JaxOptimConfig(warmup_iters=2), steps_per_epoch=STEPS_PER_EPOCH)
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                               opt_state=tx.init(params))
            mesh = make_mesh(jax.devices()[:2])
            state = jax.device_put(state, replicated_sharding(mesh))
            new_state, jm = jax_train_step(jmodel, tx, donate=False)(
                state, shard_batch(inputs, mesh), jax.random.PRNGKey(0))
            jm = {k: float(v) for k, v in jm.items()}
            ref = _port_model(KWARGS, torch.float64, new_state.params, new_state.batch_stats,
                              template)
            (adam,) = [s for s in jax.tree_util.tree_leaves(
                new_state.opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
            unclip = max(jm["grad_norm"] / 35.0, 1.0)
            jgrads = _port_model(KWARGS, torch.float64, jax.tree_util.tree_map(
                lambda m: np.asarray(m) / 0.1 * unclip, adam.mu), stats, template)
            jax_eval = JaxDepthEvaluator(lambda v, imgs: 1.0 / (1.0 + jnp.mean(
                imgs[:, 0], axis=-1, keepdims=True) * 5.0), data, batch_size=2,
                shard_across_processes=False).run({})
            del state, new_state, adam, params, stats
            release_jax_memory()
        finally:
            wait()
    ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    ranks[0].update(torch.load(tmp / "rank0.pt"))
    os.remove(tmp / "rank0.pt")
    evals = [json.loads((tmp / f"eval_rank{r}.json").read_text()) for r in range(2)]
    return jm, ranks, ref, jgrads, template, jax_eval, evals


def test_two_ranks_match_the_jax_mesh_step(runs):
    jm, ranks, ref, jgrads, template, _, _ = runs
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["ranks_equal"] and ranks[1]["ranks_equal"]
    model = copy.deepcopy(template)
    model.load_state_dict(ranks[0]["state"])
    for k, p in model.named_parameters():
        p.grad = ranks[0]["grads"][k]
    check_against_jax(jm, ranks[0]["metrics"][0], model, ref, jgrads, automask=False,
                      tol=TOL_F64)


class _Indexed:
    """Samples that read their per-sample generator."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, i, rng):
        return {"index": np.int64(i), "draw": rng.rand(3)}


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("n", [10, 13])
def test_sharded_loader_matches_jax(n, drop_last):
    ds = _Indexed(n)
    for shard in range(2):
        kw = dict(batch_size=2, shuffle=True, seed=5, num_workers=1, num_shards=2,
                  shard_index=shard, drop_last=drop_last)
        port, jax_loader = BatchLoader(ds, **kw), JaxBatchLoader(ds, **kw)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            jax_loader.set_epoch(epoch)
            np.testing.assert_array_equal(port._epoch_indices(), jax_loader._epoch_indices())
            assert len(port) == len(jax_loader) > 0
            for a, b in zip(port, jax_loader, strict=True):
                np.testing.assert_array_equal(a["index"], b["index"])
                np.testing.assert_array_equal(a["draw"], b["draw"])


def test_rank_strided_evaluator_matches_jax(runs):
    jax_eval, evals = runs[5], runs[6]
    # each rank times its own share
    assert {k: v for k, v in evals[0].items() if k != "eval_fps"} == \
        {k: v for k, v in evals[1].items() if k != "eval_fps"}
    for k, v in jax_eval.items():
        if k != "eval_fps":
            np.testing.assert_allclose(evals[0][k], v, rtol=RTOL, atol=0, err_msg=k)
