"""Data parallelism in tripled_tpu_torch (`parallel/dist.py`): a training
step on 2 gloo ranks, each on its half of a global batch of 4, against the
port's 1-process step on the whole batch, in float64 at 64x96 (R18
everywhere, the pose net at 32x64), from the same weights (two steps of
the flagship, with and without remat, one of the others):

- the small flagship (mono_fm_joint_inpaint_disentangle, 6 erased 8x8
  squares per sample, decoder dropout 0.5, automask), one source frame:
  cross-rank BatchNorm, the masked image reconstruction's global mean,
  the dropout masks drawn at the global batch's shape;
- mono_fm_joint_im_rot, one source frame, a 48-pixel crop: the softmax
  over the batch through `gather_rows`, the labels drawn for the global
  batch;
- mono_fm_joint_equivariant_inpaint with both source frames (the least of
  the frames' global means needs two) and a 2-pixel erased border;
- the small flagship again with remat (two steps): the recompute reruns
  the cross-rank BatchNorm's all-reduce on every rank in the same order,
  and leaves the running statistics alone, which end as without remat.

Held within 1e-9: every loss term, the gradient norm, every parameter
after each step's update and the BatchNorm running statistics (float64
arithmetic in another summation order; seen below 1e-12). The ranks hold
bit-equal parameters. One spawn runs all four and `train_mono` on a
small in-memory dataset in a work dir of each rank's own: rank 0 alone
writes metrics.jsonl and the checkpoint. The ranks import no JAX
(`tests/torch_port_ddp_worker.py`).
"""

import json
import os

import numpy as np
import pytest
import torch

from torch_port_ddp_worker import build, global_batch, run_steps, spawn_ranks
from tripled_tpu_torch.data.transforms import make_erase_mask

torch.set_num_threads(1)

B, H, W = 4, 64, 96  # the global batch; 2 rows a rank
STEPS = {"flagship": 2, "flagship_remat": 2, "im_rot": 1, "equivariant": 1}
TOL = 1e-9

SMALL = dict(depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18, height=H,
             width=W, pose_height=32, pose_width=64, dis=1e-3, cvt=1e-3,
             perception_weight=1e-3, smoothness_weight=1e-3, skip_connection_multiplier=1.0)
CASES = {
    "flagship": dict(SMALL, name="mono_fm_joint_inpaint_disentangle", frame_ids=(0, 1),
                     depth_dropout_rate=0.5, automask=True, auto_res_weight=5e-3,
                     disentangle_layers=(False, False, False, False, True),
                     depth_disentangle_type="use_half"),
    "im_rot": dict(SMALL, name="mono_fm_joint_im_rot", frame_ids=(0, 1),
                   depth_dropout_rate=0.0, automask=False, pretext_resize=48,
                   pretext_label_size=4, pretext_weight=1.0),
    "equivariant": dict(SMALL, name="mono_fm_joint_equivariant_inpaint",
                        frame_ids=(0, -1, 1), depth_dropout_rate=0.0, automask=False,
                        equivariant_weight=1e-3),
}
# the flagship with remat: the recompute reruns BatchNorm's all-reduce on
# every rank and leaves the running statistics alone
CASES["flagship_remat"] = dict(CASES["flagship"], remat=True)


def make_inputs(frames, erase_border=False, dtype=np.float64, batch=B, seed=0):
    """Frames, intrinsics and 6 erased 8x8 squares per sample from a numpy
    seed."""
    rng = np.random.RandomState(seed)
    K = np.tile(np.eye(4), (batch, 1, 1))
    K[:, 0, 0], K[:, 1, 1], K[:, 0, 2], K[:, 1, 2] = 0.58 * W, 1.92 * H, 0.5 * W, 0.5 * H
    mask = np.stack([make_erase_mask(rng, H, W, (8, 8), 6) for _ in range(batch)])
    if erase_border:
        mask[:, :2], mask[:, -2:], mask[:, :, :2], mask[:, :, -2:] = 0, 0, 0, 0
    inputs = {"color": rng.rand(batch, frames, H, W, 3),
              "color_aug": rng.rand(batch, frames, H, W, 3),
              "K": K, "inv_K": np.linalg.inv(K), "mask": mask}
    return {k: v.astype(dtype) for k, v in inputs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results and the 1-process reference's, by case."""
    tmp = tmp_path_factory.mktemp("ddp")
    spec = {"cases": []}
    for name, kwargs in CASES.items():
        d = tmp / name
        d.mkdir()
        np.savez(d / "inputs.npz", **make_inputs(len(kwargs["frame_ids"]),
                                                 erase_border=name == "equivariant"))
        # the weights: drawn from seed 0 on the CPU alike in every process
        spec["cases"].append(dict(kwargs=kwargs, dtype="float64",
                                  inputs=str(d / "inputs.npz"), dir=str(d), steps=STEPS[name],
                                  seed=7, optim={"warmup_iters": 2}))
    loop = tmp / "loop"
    loop.mkdir()
    np.savez(loop / "inputs.npz", **make_inputs(2, dtype=np.float32, batch=8, seed=1))
    spec["loop"] = dict(kwargs=dict(CASES["flagship"], depth_dropout_rate=0.0),
                        batch_size=2, inputs=str(loop / "inputs.npz"), dir=str(loop))
    wait = spawn_ranks(spec, tmp)
    try:
        # the reference while the ranks run
        reference = {}
        for case in spec["cases"]:
            model, optimizer = build(case["kwargs"], torch.float64, None, case["optim"])
            metrics = run_steps(model, optimizer, global_batch(case["inputs"]), case["steps"],
                                case["seed"])
            reference[os.path.basename(case["dir"])] = {"metrics": metrics,
                                                        "state": model.state_dict()}
    finally:
        wait()
    ranks = {}
    for name in CASES:
        ranks[name] = [json.loads((tmp / name / f"rank{r}.json").read_text()) for r in range(2)]
        ranks[name][0].update(torch.load(tmp / name / "rank0.pt"))
        os.remove(tmp / name / "rank0.pt")  # a few hundred MB in float64
    return ranks, reference, loop


@pytest.mark.parametrize("name", list(CASES))
def test_two_ranks_match_one_process(runs, name):
    ranks, reference, _ = runs
    want = reference[name]
    for got in ranks[name]:
        assert got["count"] == STEPS[name] == len(want["metrics"])
        for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                           err_msg=f"{name} step {step} {k}")
    for k, v in want["state"].items():
        np.testing.assert_allclose(ranks[name][0]["state"][k].numpy(), v.numpy(), rtol=0,
                                   atol=TOL, err_msg=f"{name} {k}")
    if name == "equivariant":
        assert all(want["metrics"][0][f"min_equivariant_loss/{s}"] > 0 for s in range(4))
    if name == "flagship_remat":
        # the ranks' running statistics and batch counts as without remat:
        # the recompute moved none of them
        plain = ranks["flagship"][0]["state"]
        stats = [k for k in want["state"] if "running" in k or "num_batches" in k]
        assert stats
        for k in stats:
            np.testing.assert_allclose(ranks[name][0]["state"][k].numpy(), plain[k].numpy(),
                                       rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_equal_parameters(runs, name):
    first, second = runs[0][name]
    assert first["metrics"] == second["metrics"]
    assert first["ranks_equal"] and second["ranks_equal"]


def test_only_rank_0_logs_and_saves(runs):
    loop = runs[2]
    states = [json.loads((loop / f"loop_rank{r}.json").read_text()) for r in range(2)]
    # 8 frames, a global batch of 4: two steps an epoch
    assert [s["count"] for s in states] == [2, 2]
    assert all(s["ranks_equal"] for s in states)
    with open(loop / "work0" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "train/loss" in r] == [1, 2]
    epoch = [r for r in rows if "epoch/images_per_s" in r]
    assert len(epoch) == 1 and epoch[0]["epoch/steps"] == 2
    assert sorted(os.listdir(loop / "work0" / "ckpt")) == ["epoch_1.pt", "latest"]
    assert not os.path.exists(loop / "work1" / "metrics.jsonl")
    assert not os.path.exists(loop / "work1" / "ckpt")


def test_cuda_rank_without_a_card_raises(monkeypatch, tmp_path):
    """Under torchrun's variables, the train CLI asked for the card (its
    default) raises where none is visible: no rank goes on on the CPU or
    over gloo."""
    from tripled_tpu_torch.cli import train
    from tripled_tpu_torch.parallel import dist

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CLI would train on it")
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="2", MASTER_ADDR="localhost",
                     MASTER_PORT="29500").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--config", str(tmp_path / "unread.py")])
    assert dist.world_size() == 1 and not dist.initialized()
