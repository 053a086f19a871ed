"""Sample transforms (`tripled_tpu/data/transforms.py`), numpy only. So far
the inpaint erase mask; the data layer adds the rest."""

from __future__ import annotations

import numpy as np


def make_erase_mask(rng: np.random.RandomState, height: int, width: int,
                    erase_shape, erase_count: int) -> np.ndarray:
    """Random rectangular erase mask, (H, W, 1) float32, 1 = keep and 0
    inside the erased squares: the same draws from `rng` as
    `tripled_tpu/data/transforms.py:116-135`. One square is the centred
    square of side erase_shape[0]."""
    mask = np.ones((height, width, 1), np.float32)
    eh, ew = int(erase_shape[0]), int(erase_shape[1])
    if erase_count == 1:
        off = (height - eh) // 2
        mask[off:off + eh, off:off + eh] = 0
        return mask
    for _ in range(erase_count):
        row = rng.randint(0, height - eh - 1)
        col = rng.randint(0, width - ew - 1)
        mask[row:row + eh, col:col + ew] = 0
    return mask
