"""Random model inputs in the JAX package's layout (for smoke runs and
profiles): the dict of `bench.py`'s `_inputs`, made with numpy from a seed."""

from __future__ import annotations

import numpy as np
import torch


def kitti_intrinsics(batch: int, height: int, width: int) -> np.ndarray:
    K = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    K[:, 0, 0] = 0.58 * width
    K[:, 1, 1] = 1.92 * height
    K[:, 0, 2] = 0.5 * width
    K[:, 1, 2] = 0.5 * height
    return K


def random_train_inputs(batch: int, height: int, width: int, seed: int = 0,
                        num_frames: int = 3, device="cuda") -> dict:
    """color / color_aug (B, F, H, W, 3) in [0, 1), K and inv_K (B, 4, 4)."""
    rng = np.random.RandomState(seed)
    K = kitti_intrinsics(batch, height, width)
    arrays = {
        "color": rng.rand(batch, num_frames, height, width, 3).astype(np.float32),
        "color_aug": rng.rand(batch, num_frames, height, width, 3).astype(np.float32),
        "K": K,
        "inv_K": np.linalg.inv(K).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
