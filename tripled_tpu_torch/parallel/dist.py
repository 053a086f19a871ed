"""Data parallelism over torch.distributed (`tripled_tpu/parallel/mesh.py`).

A rank of the port stands where a process of the JAX package stands: it
reads its own `batch_size` rows (`BatchLoader(num_shards=world_size(),
shard_index=rank())`), so the global batch is `batch_size * world_size()`,
and a step on R ranks computes what the JAX step computes on that global
batch over a mesh. Where the JAX step reduces over the global batch, the
port reduces across ranks:

- gradients: `all_reduce_grads`, the reference's coalesced all-reduce
  (flat buckets by dtype, divided by the world size;
  `mono/core/utils/dist_utils.py`), between the backward and the
  optimizer, so that the clip and the gradient norm see the global
  gradient. No `DistributedDataParallel`: its hooks would meet the frozen
  extractor's unused parameters and `remat`'s recompute;
- BatchNorm's batch statistics (`models/layers.BatchNorm`);
- the loss terms coupled across the batch: masked means (`global_ratio`),
  the least of global means (`global_min`), the rotation pretext's softmax
  over the batch (`gather_rows`);
- the step's random draws: every rank draws at the global batch's shape
  from a generator seeded alike and keeps its rows (`rank_rows`).

Each rank backpropagates its own loss; a cross-rank term's backward sums
the ranks' contributions, and the gradients' all-reduce divides the sum by
the world size. So the averaged gradient is the gradient of the global
loss, and a 2-rank step equals the 1-process step on the same frames.

Without a process group every function acts as rank 0 of 1 and leaves its
input as it is. `init_from_env` joins the group torchrun describes: NCCL on
a card, gloo on the CPU; a group that does not come up raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main() -> bool:
    return rank() == 0


def backend_name() -> str:
    """The group's backend ("nccl", "gloo"), or "none" without a group."""
    return str(dist.get_backend()) if initialized() else "none"


def init_from_env(device="cuda", backend: str | None = None) -> torch.device:
    """Join the process group of torchrun's `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`, and return this rank's
    device. A CUDA device without an index becomes `cuda:LOCAL_RANK`; the
    backend is NCCL on CUDA and gloo on the CPU unless `backend` names one
    (gloo lets two ranks share one card, which NCCL refuses). One all-reduce
    checks that the group works: a backend that does not come up raises."""
    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} asked for, but no CUDA device is visible")
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("NCCL asked for, but this torch build has none")
    if not initialized():
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                device_id=device if backend == "nccl" else None)
    probe = torch.ones((), device=device)
    dist.all_reduce(probe)
    if probe.item() != world_size():
        raise RuntimeError(f"the {backend} group's first all-reduce gave {probe.item()}, "
                           f"not the world size {world_size()}")
    return device


def destroy() -> None:
    if initialized():
        dist.destroy_process_group()


def barrier(device) -> None:
    """Wait for every rank: an all-reduce on `device`, which NCCL and gloo
    both take, whose result the host reads, so that the host waits until
    every rank has joined it (NCCL's all-reduce alone returns at once)."""
    if world_size() > 1:
        t = torch.zeros((), device=device)
        dist.all_reduce(t)
        t.item()


def _by_dtype(tensors):
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups.values()


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, optimizer=None, src: int = 0) -> None:
    """Copy rank `src`'s parameters, buffers and, where given, the Adam
    moments and update count to every rank, as DDP does when it wraps a
    model: one flat broadcast per dtype."""
    if world_size() == 1:
        return
    tensors = list(model.state_dict(keep_vars=True).values())
    if optimizer is not None:
        tensors += [t for key in ("mu", "nu") for ts in getattr(optimizer, key).values()
                    for t in ts]
        count = torch.tensor([optimizer.count], dtype=torch.int64, device=tensors[0].device)
        tensors.append(count)
    for group in _by_dtype([t.data if isinstance(t, torch.nn.Parameter) else t
                            for t in tensors]):
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.broadcast(flat, src)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
    if optimizer is not None:
        optimizer.count = int(count.item())


def _check_same_list(grads, params, device) -> None:
    """Raise unless every rank holds gradients for the same parameters."""
    index = torch.tensor([i for i, p in enumerate(params) if p.grad is not None],
                         dtype=torch.int64)
    numel = torch.tensor([g.numel() for g in grads], dtype=torch.int64)
    sig = torch.stack([torch.tensor(len(grads)), numel.sum(),
                       ((index + 1) * (numel % 1_000_003)).sum() % 2**31])
    both = torch.cat([sig, -sig]).to(device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    if not torch.equal(both[:3], -both[3:]):
        raise RuntimeError(f"ranks reduce different gradient lists (this rank: {sig.tolist()}; "
                           f"max {both[:3].tolist()}, min {(-both[3:]).tolist()})")


@torch.no_grad()
def all_reduce_grads(params) -> None:
    """Average the `.grad` of `params` over the ranks in place: the
    gradients grouped by dtype, each group flattened into one bucket,
    all-reduced (summed) and divided by the world size. Parameters without
    a gradient are left out, and every rank must leave out the same ones:
    a check before the buckets raises otherwise."""
    world = world_size()
    if world == 1:
        return
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    _check_same_list(grads, params, grads[0].device)
    for group in _by_dtype(grads):
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def global_sum(x: torch.Tensor) -> torch.Tensor:
    """x summed over the ranks, without a gradient."""
    x = x.detach().clone()
    if world_size() > 1:
        dist.all_reduce(x)
    return x


@torch.no_grad()
def all_mean(x: torch.Tensor) -> torch.Tensor:
    """x averaged over the ranks, without a gradient (the logged metrics)."""
    return global_sum(x) / world_size()


def rank_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of `x`, a tensor of the global batch along dim 0
    (each rank holds an equal, contiguous share, as `BatchLoader` gives)."""
    world = world_size()
    if world == 1:
        return x
    n = x.shape[0] // world
    return x[rank() * n:(rank() + 1) * n]


def _gather(x: torch.Tensor) -> torch.Tensor:
    # an all-gather, as the all-reduce of a zero tensor of the global shape
    # holding this rank's rows in place: exact (each element is one rank's
    # value plus zeros), and taken by NCCL and by gloo on CUDA tensors alike
    world, n = world_size(), x.shape[0]
    out = x.new_zeros((world * n, *x.shape[1:]))
    out[rank() * n:(rank() + 1) * n] = x
    dist.all_reduce(out)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return rank_rows(g)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x` (equal counts), in rank order, along dim 0.
    The backward sums the ranks' gradients of the gathered tensor and
    keeps this rank's rows. Integer tensors are gathered without a
    gradient."""
    if world_size() == 1:
        return x
    if not x.is_floating_point():
        return _gather(x)
    return _GatherRows.apply(x)


def global_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The rank's share of sum(num) / sum(den) over the ranks, for a
    denominator without a gradient (a mask's count): num * R / sum(den),
    whose mean over the ranks is the global ratio and whose averaged
    gradient is its gradient. num / den in one process."""
    world = world_size()
    if world == 1:
        return num / den
    return num * world / global_sum(den)


def global_min(values: torch.Tensor) -> torch.Tensor:
    """The entry of the 1-d `values`, each a rank's share of a global mean
    (`global_ratio`), whose mean over the ranks is least: the least of the
    global means, as the rank's share. values.min() in one process."""
    if world_size() == 1:
        return values.min()
    return values[torch.argmin(all_mean(values))]
