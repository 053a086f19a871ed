"""Random model inputs in the JAX package's layout (for smoke runs and
profiles): the dict of `bench.py`'s `_inputs`, made with numpy from a seed."""

from __future__ import annotations

import numpy as np
import torch

from tripled_tpu_torch.data.transforms import make_erase_mask


def kitti_intrinsics(batch: int, height: int, width: int) -> np.ndarray:
    K = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    K[:, 0, 0] = 0.58 * width
    K[:, 1, 1] = 1.92 * height
    K[:, 0, 2] = 0.5 * width
    K[:, 1, 2] = 0.5 * height
    return K


def random_train_inputs(batch: int, height: int, width: int, seed: int = 0,
                        num_frames: int = 3, erase_count: int = 0,
                        erase_shape=(16, 16), device="cuda", frame_ids=None) -> dict:
    """color / color_aug (B, F, H, W, 3) in [0, 1), K and inv_K (B, 4, 4);
    with erase_count > 0 also the inpaint `mask` (B, H, W, 1), one
    `make_erase_mask` per sample drawn from the same RandomState, as the
    inpaint dataset draws one per sample. `frame_ids`, where given, sets F;
    with "s" among them also `stereo_T` (B, 4, 4), as the datasets build it
    (`data/datasets.py`): the identity with a 0.015 baseline in x whose
    sign, the side's times the flip's, is drawn per sample after the rest."""
    if frame_ids is not None:
        num_frames = len(frame_ids)
    rng = np.random.RandomState(seed)
    K = kitti_intrinsics(batch, height, width)
    arrays = {
        "color": rng.rand(batch, num_frames, height, width, 3).astype(np.float32),
        "color_aug": rng.rand(batch, num_frames, height, width, 3).astype(np.float32),
        "K": K,
        "inv_K": np.linalg.inv(K).astype(np.float32),
    }
    if erase_count > 0:
        arrays["mask"] = np.stack([make_erase_mask(rng, height, width, erase_shape, erase_count)
                                   for _ in range(batch)])
    if frame_ids is not None and "s" in frame_ids:
        stereo_T = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
        stereo_T[:, 0, 3] = np.where(rng.rand(batch) > 0.5, 0.015, -0.015)
        arrays["stereo_T"] = stereo_T
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def random_segmentation_inputs(batch: int, height: int, width: int, seed: int = 0,
                               num_classes: int = 20, device="cuda") -> dict:
    """image (B, H, W, 3), uniform frames normalised as the segmentation
    datasets normalise them (ImageNet mean and std), and label (B, H, W)
    int32 train ids in [0, num_classes), the void id 19 among them."""
    from tripled_tpu_torch.data.seg_transforms import IMAGENET_MEAN, IMAGENET_STD

    rng = np.random.RandomState(seed)
    image = (rng.rand(batch, height, width, 3).astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
    label = rng.randint(0, num_classes, (batch, height, width)).astype(np.int32)
    return {"image": torch.from_numpy(image).to(device),
            "label": torch.from_numpy(label).to(device)}
