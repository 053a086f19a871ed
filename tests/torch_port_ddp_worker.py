"""One rank of the data-parallel tests (`test_torch_port_ddp*.py`), run as

    python tests/torch_port_ddp_worker.py RANK WORLD PORT SPEC.json

It joins a gloo group on the CPU through the environment torchrun would
set, and for each case of the spec takes `steps` training steps of the
port on its rows of the case's global batch (`inputs.npz`, dim 0), from
the case's initial state dict (`state.pt`) and generators seeded alike on
every rank (with `fixed_pretext`, a fixed pretext crop and labels). It
writes `rank{R}.json` into the case's directory (the metrics of each
step, the update count, and whether every rank holds the same parameters
and buffers), and rank 0 `rank0.pt`, the state dict and the gradients
after the last step. A `loop` entry runs `train_mono` on a small
in-memory dataset in the rank's own work dir, and
an `eval` entry the rank-strided `DepthEvaluator`. Imports no JAX.
"""

import contextlib
import json
import os
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tripled_tpu_torch.config import (  # noqa: E402
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    OptimConfig,
)
from tripled_tpu_torch.parallel import dist  # noqa: E402
from tripled_tpu_torch.train.optim import Adam  # noqa: E402
from tripled_tpu_torch.train.state import create_train_state  # noqa: E402
from tripled_tpu_torch.train.step import make_train_step  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build(kwargs, dtype, state_path, optim_kwargs):
    """The port's model of `kwargs` in `dtype`, drawn from seed 0 or, where
    `state_path` is given, holding the state dict there; and its Adam. The
    ResNet kernels keep nn.Conv2d's own draw from the seed (the truncated
    normal redraw takes seconds on one thread): alike in every process."""
    with mock.patch.object(torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
        model = create_train_state(ModelConfig(**kwargs), OptimConfig(), 100, seed=0,
                                   device="cpu").model.to(dtype)
    if state_path:
        model.load_state_dict(torch.load(state_path))
    return model, Adam(model, OptimConfig(**optim_kwargs), 100)


@torch.no_grad()
def same_on_every_rank(model: torch.nn.Module) -> bool:
    """Whether every rank holds the same parameters and buffers, bit for
    bit: the elementwise max over the ranks of x and of -x meet."""
    flat = torch.cat([t.reshape(-1).double() for t in model.state_dict().values()])
    hi, neg_lo = flat.clone(), -flat
    if dist.world_size() > 1:
        torch.distributed.all_reduce(hi, op=torch.distributed.ReduceOp.MAX)
        torch.distributed.all_reduce(neg_lo, op=torch.distributed.ReduceOp.MAX)
    return bool(torch.equal(hi, -neg_lo))


def run_steps(model, optimizer, batch, steps, seed):
    """`steps` steps on `batch`; the dropout, pretext and automask
    generators seeded from `seed` as train/loop.py seeds them."""
    step = make_train_step(model, optimizer)
    gens = (torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed + 1),
            torch.Generator().manual_seed(seed + 2))
    return [{k: float(v) for k, v in step(batch, *gens).items()} for _ in range(steps)]


def global_batch(path):
    with np.load(path) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def fixed_pretext(offset, labels):
    """The rotation pretext's draw replaced by a fixed crop offset and the
    global batch's labels, of which the rank keeps its rows (the JAX
    comparison fixes the JAX package's draws alike)."""
    from tripled_tpu_torch.models import aux_nets

    return mock.patch.object(aux_nets, "draw_pretext", lambda generator, batch, h, w, size: (
        *offset, dist.rank_rows(torch.tensor(labels[:batch * dist.world_size()]))))


def run_case(case):
    model, optimizer = build(case["kwargs"], DTYPES[case["dtype"]], case.get("state"),
                             case.get("optim", {}))
    batch = {k: dist.rank_rows(v) for k, v in global_batch(case["inputs"]).items()}
    draws = case.get("fixed_pretext")
    with fixed_pretext(**draws) if draws else contextlib.nullcontext():
        metrics = run_steps(model, optimizer, batch, case["steps"], case["seed"])
    with open(os.path.join(case["dir"], f"rank{dist.rank()}.json"), "w") as f:
        json.dump({"metrics": metrics, "count": optimizer.count,
                   "ranks_equal": same_on_every_rank(model)}, f)
    if dist.is_main():  # the state of one rank: the ranks hold the same
        torch.save({"state": model.state_dict(),
                    "grads": {k: p.grad for k, p in model.named_parameters()}},
                   os.path.join(case["dir"], "rank0.pt"))


class ArrayDataset:
    """The frames of `inputs.npz` as a dataset of samples."""

    def __init__(self, path):
        with np.load(path) as f:
            self.arrays = {k: f[k] for k in f.files}

    def __len__(self):
        return len(self.arrays["color"])

    def sample(self, i, rng):
        return {k: v[i] for k, v in self.arrays.items()}


def run_loop(spec):
    from tripled_tpu_torch.train.loop import train_mono

    cfg = ExperimentConfig(
        model=ModelConfig(**spec["kwargs"]),
        data=DataConfig(batch_size=spec["batch_size"], shuffle=True),
        optim=OptimConfig(total_epochs=1),
        work_dir=os.path.join(spec["dir"], f"work{dist.rank()}"),
        seed=3, validate=False, log_interval=1)
    state, _ = train_mono(cfg, train_dataset=ArrayDataset(spec["inputs"]), device="cpu")
    with open(os.path.join(spec["dir"], f"loop_rank{dist.rank()}.json"), "w") as f:
        json.dump({"count": state.optimizer.count,
                   "ranks_equal": same_on_every_rank(state.model)}, f)


class EvalDataset:
    """Images and ground-truth depths from `eval.npz`."""

    def __init__(self, path):
        with np.load(path) as f:
            self.imgs = f["imgs"]
            self.gt_depths = list(f["gt"])

    def __len__(self):
        return len(self.imgs)

    def sample(self, i, rng):
        return {"color": self.imgs[i]}


def run_eval(spec):
    from tripled_tpu_torch.eval.evaluator import DepthEvaluator

    def predict(imgs):  # a fixed function of the image, as the JAX test's
        return 1.0 / (1.0 + imgs[:, 0].mean(dim=-1, keepdim=True) * 5.0)

    metrics = DepthEvaluator(predict, EvalDataset(spec["inputs"]), batch_size=2,
                             device="cpu").run()
    with open(os.path.join(spec["dir"], f"eval_rank{dist.rank()}.json"), "w") as f:
        json.dump(metrics, f)


def spawn_ranks(spec: dict, tmp, world: int = 2, timeout: float = 600):
    """Start `world` ranks of this script on `spec` (written to tmp) over a
    free localhost port, and return a function that waits for them and
    raises with a rank's output if it failed."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spec_path = os.path.join(str(tmp), "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), spec_path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]

    def wait():
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{out[-4000:]}")
        return outs

    return wait


def main():
    rank, world, port, spec_path = sys.argv[1:5]
    os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=world, MASTER_ADDR="localhost",
                      MASTER_PORT=port)
    torch.set_num_threads(1)
    dist.init_from_env("cpu")
    try:
        with open(spec_path) as f:
            spec = json.load(f)
        for case in spec.get("cases", []):
            run_case(case)
        if "loop" in spec:
            run_loop(spec["loop"])
        if "eval" in spec:
            run_eval(spec["eval"])
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()

