"""Checkpoints (`tripled_tpu/train/checkpoint.py`): `<work_dir>/ckpt/epoch_N.pt`
and a `latest` file naming the newest, as the JAX package keeps
`epoch_N/` and `latest`. A checkpoint holds the model's state_dict
(parameters and BatchNorm statistics), the optimizer's moments and count,
and the epoch."""

from __future__ import annotations

import os

import torch

from tripled_tpu_torch.train.state import TrainState


def _ckpt_dir(work_dir: str) -> str:
    return os.path.join(os.path.abspath(work_dir), "ckpt")


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def save_checkpoint(work_dir: str, state: TrainState, epoch: int) -> str:
    ckpt_dir = _ckpt_dir(work_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"epoch_{epoch}.pt"
    path = os.path.join(ckpt_dir, name)
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "epoch": epoch}
    _write_atomic(path, lambda p: torch.save(payload, p))

    def write_latest(p):
        with open(p, "w") as f:
            f.write(name)

    _write_atomic(os.path.join(ckpt_dir, "latest"), write_latest)
    return path


def checkpoint_path(path_or_work_dir: str) -> str:
    """A work dir's latest checkpoint, or the checkpoint at the path given,
    with or without its `.pt`."""
    latest = os.path.join(_ckpt_dir(path_or_work_dir), "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            return os.path.join(_ckpt_dir(path_or_work_dir), f.read().strip())
    if not os.path.exists(path_or_work_dir) and os.path.exists(path_or_work_dir + ".pt"):
        return path_or_work_dir + ".pt"
    return path_or_work_dir


def _load(path_or_work_dir: str, state: TrainState) -> dict:
    device = next(state.model.parameters()).device
    return torch.load(checkpoint_path(path_or_work_dir), map_location=device, weights_only=True)


def restore_checkpoint(path_or_work_dir: str, state: TrainState) -> tuple[TrainState, int]:
    """Restore the model and optimizer of `state` in place; returns the
    state and the checkpoint's epoch."""
    saved = _load(path_or_work_dir, state)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    return state, int(saved["epoch"])


def load_weights(path: str, state: TrainState) -> TrainState:
    """Weights only, for `finetune` / `load_from`: the model's tensors that
    the checkpoint holds (non-strict, as the reference loads them); the
    optimizer stays fresh."""
    state.model.load_state_dict(_load(path, state)["model"], strict=False)
    return state
