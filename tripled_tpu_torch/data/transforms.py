"""Host-side sample transforms (`tripled_tpu/data/transforms.py`), numpy
and PIL: decode, Lanczos resize, the shared ColorJitter (p = 0.5;
brightness, contrast, saturation 0.8-1.2, hue +-0.1), the inpaint erase
mask and the map-pose motion mask. The colour functions take float32 RGB
(H, W, 3) in [0, 1]."""

from __future__ import annotations

import numpy as np
from PIL import Image

_GRAY_W = np.array([0.299, 0.587, 0.114], np.float32)


def load_image(path: str) -> Image.Image:
    with open(path, "rb") as f:
        return Image.open(f).convert("RGB")


def resize_antialias(img: Image.Image, height: int, width: int) -> Image.Image:
    """PIL Lanczos resize."""
    return img.resize((width, height), Image.LANCZOS)


def to_float(img: Image.Image) -> np.ndarray:
    return np.asarray(img, np.float32) / 255.0


def adjust_brightness(x: np.ndarray, factor: float) -> np.ndarray:
    return np.clip(x * factor, 0.0, 1.0)


def adjust_contrast(x: np.ndarray, factor: float) -> np.ndarray:
    # torchvision: blend with the mean of the grayscale image
    mean = (x @ _GRAY_W).mean()
    return np.clip(mean + (x - mean) * factor, 0.0, 1.0)


def adjust_saturation(x: np.ndarray, factor: float) -> np.ndarray:
    gray = (x @ _GRAY_W)[..., None]
    return np.clip(gray + (x - gray) * factor, 0.0, 1.0)


def adjust_hue(x: np.ndarray, delta: float) -> np.ndarray:
    """Hue shift by `delta` (a fraction of a turn) through HSV, branch-free:
    channel n in (5 = R, 3 = G, 1 = B) is v - v*s*clip(min(k, 4 - k), 0, 1)
    with k = (n + 6h) mod 6."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-12), 0.0)
    safe_c = np.maximum(c, 1e-12)
    h = np.where(
        maxc == r, ((g - b) / safe_c) % 6.0,
        np.where(maxc == g, (b - r) / safe_c + 2.0, (r - g) / safe_c + 4.0),
    )
    h = np.where(c > 0, h / 6.0, 0.0)
    h6 = ((h + delta) % 1.0) * 6.0
    vs = maxc * s

    def chan(n):
        k = (n + h6) % 6.0
        return maxc - vs * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0)

    out = np.stack([chan(5.0), chan(3.0), chan(1.0)], axis=-1)
    return np.clip(out, 0.0, 1.0)


class ColorJitter:
    """torchvision-style ColorJitter: one draw of factors and order, applied
    to every frame of a sample."""

    def __init__(self, brightness=(0.8, 1.2), contrast=(0.8, 1.2), saturation=(0.8, 1.2),
                 hue=(-0.1, 0.1)):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def sample(self, rng: np.random.RandomState):
        """Draw brightness, contrast, saturation, hue, then the order, from
        `rng`; returns the function that applies them."""
        b = rng.uniform(*self.brightness)
        c = rng.uniform(*self.contrast)
        s = rng.uniform(*self.saturation)
        h = rng.uniform(*self.hue)
        ops = [
            lambda x: adjust_brightness(x, b),
            lambda x: adjust_contrast(x, c),
            lambda x: adjust_saturation(x, s),
            lambda x: adjust_hue(x, h),
        ]
        order = rng.permutation(4)

        def apply(x):
            for i in order:
                x = ops[i](x)
            return x

        return apply


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


def motion_mask(target: np.ndarray, source: np.ndarray, blur_kernel: int = 9,
                threshold: float | None = None) -> np.ndarray:
    """Frame-difference motion mask, (H, W, 1) float32, 1 where the
    box-blurred grey difference exceeds Otsu's threshold (or `threshold`),
    computed as `tripled_tpu/data/transforms.py:138-179` computes it. The
    frames are scaled by 255 as floats in [0, 1] are; uint8 frames
    (DataConfig.ship_uint8) are scaled all the same, as the JAX package
    scales them, so their differences mostly fall past the 0-255 histogram."""
    tg = (target @ _GRAY_W * 255).astype(np.float32)
    sg = (source @ _GRAY_W * 255).astype(np.float32)
    diff = np.abs(sg - tg)
    kernel = np.ones(blur_kernel, np.float32) / blur_kernel
    blurred = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, diff)
    blurred = np.apply_along_axis(lambda c: np.convolve(c, kernel, mode="same"), 0, blurred)
    if threshold is None:
        threshold = _otsu(blurred)
    return (blurred > threshold).astype(np.float32)[..., None]


def _otsu(img: np.ndarray) -> float:
    """The centre of the 256-bin (0-255) histogram bin that maximises the
    between-class variance; 0 for an empty histogram."""
    hist, bin_edges = np.histogram(img.reshape(-1), bins=256, range=(0, 255))
    hist = hist.astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0.0
    w0 = np.cumsum(hist)
    w1 = total - w0
    centers = (bin_edges[:-1] + bin_edges[1:]) / 2
    cum_mean = np.cumsum(hist * centers)
    mean_total = cum_mean[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = cum_mean / w0
        mu1 = (mean_total - cum_mean) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between = np.nan_to_num(between)
    return float(centers[int(between.argmax())])
