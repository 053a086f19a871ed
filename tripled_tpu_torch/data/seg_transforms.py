"""Joint image+mask transforms for segmentation pipelines
(`tripled_tpu/data/seg_transforms.py`), numpy and PIL: Resize (optionally
image-only), random rescale/crop/rotate/flips, ConvertSegmentation (raw id
→ train id), ColorJitter with gamma + fraction, GaussianBlur,
NormalizeZeroMean, Compose.

Each transform maps a sample dict {'image': float32 HWC [0,1],
'label': int32 HW raw ids or None} → same structure; label geometry always
uses NEAREST. Each draws from the sample's `np.random.RandomState` in the
JAX package's order, so that a sample is bit-equal to its.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageFilter

from tripled_tpu_torch.data import transforms as T
from tripled_tpu_torch.data.cityscapes_labels import id_to_trainid_lut

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


def _resize_img(img, h, w, nearest=False):
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(
        Image.fromarray((img * 255).astype(np.uint8)).resize((w, h), mode),
        np.float32,
    ) / 255.0


def _resize_label(label, h, w):
    return np.asarray(
        Image.fromarray(label.astype(np.uint8)).resize((w, h), Image.NEAREST)
    )


class Resize:
    def __init__(self, size, only_img=False):
        self.h, self.w = size
        self.only_img = only_img

    def __call__(self, s, rng):
        s = dict(s)
        s["image"] = _resize_img(s["image"], self.h, self.w)
        if not self.only_img and s.get("label") is not None:
            s["label"] = _resize_label(s["label"], self.h, self.w)
        return s


class RandomRescale:
    def __init__(self, max_scale=1.5):
        self.max_scale = max_scale

    def __call__(self, s, rng):
        f = rng.uniform(1.0, self.max_scale)
        h, w = s["image"].shape[:2]
        nh, nw = int(h * f), int(w * f)
        s = dict(s)
        s["image"] = _resize_img(s["image"], nh, nw)
        if s.get("label") is not None:
            s["label"] = _resize_label(s["label"], nh, nw)
        return s


class RandomCrop:
    def __init__(self, size):
        self.h, self.w = size

    def __call__(self, s, rng):
        h, w = s["image"].shape[:2]
        i = rng.randint(0, max(h - self.h, 0) + 1)
        j = rng.randint(0, max(w - self.w, 0) + 1)
        s = dict(s)
        s["image"] = s["image"][i : i + self.h, j : j + self.w]
        if s.get("label") is not None:
            s["label"] = s["label"][i : i + self.h, j : j + self.w]
        return s


class CenterCrop:
    def __init__(self, size):
        self.h, self.w = size

    def __call__(self, s, rng):
        h, w = s["image"].shape[:2]
        i, j = (h - self.h) // 2, (w - self.w) // 2
        s = dict(s)
        s["image"] = s["image"][i : i + self.h, j : j + self.w]
        if s.get("label") is not None:
            s["label"] = s["label"][i : i + self.h, j : j + self.w]
        return s


class RandomHorizontalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, s, rng):
        if rng.rand() < self.p:
            s = dict(s)
            s["image"] = s["image"][:, ::-1].copy()
            if s.get("label") is not None:
                s["label"] = s["label"][:, ::-1].copy()
        return s


class RandomVerticalFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, s, rng):
        if rng.rand() < self.p:
            s = dict(s)
            s["image"] = s["image"][::-1].copy()
            if s.get("label") is not None:
                s["label"] = s["label"][::-1].copy()
        return s


class RandomRotate:
    def __init__(self, max_deg=10.0):
        self.max_deg = max_deg

    def __call__(self, s, rng):
        deg = rng.uniform(-self.max_deg, self.max_deg)
        s = dict(s)
        img = Image.fromarray((s["image"] * 255).astype(np.uint8))
        s["image"] = np.asarray(img.rotate(deg, Image.BILINEAR), np.float32) / 255.0
        if s.get("label") is not None:
            lab = Image.fromarray(s["label"].astype(np.uint8))
            s["label"] = np.asarray(lab.rotate(deg, Image.NEAREST))
        return s


class ConvertSegmentation:
    """Raw Cityscapes/KITTI label ids → train ids (void → 19)."""

    def __init__(self, labels=None):
        self.lut = id_to_trainid_lut()

    def __call__(self, s, rng):
        if s.get("label") is not None:
            s = dict(s)
            s["label"] = self.lut[np.clip(s["label"], 0, 255)].astype(np.int32)
        return s


class ColorJitter:
    """brightness/contrast/saturation/hue ± gamma, applied with prob `fraction`."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
                 gamma=0.0, fraction=0.5):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.gamma = gamma
        self.fraction = fraction

    def __call__(self, s, rng):
        # brightness / contrast / saturation clamp the lower bound at 0,
        # hue clamps to [-0.5, 0.5], and gamma draws from [1, 1+gamma] (NOT
        # symmetric)
        if rng.rand() > self.fraction:
            return s
        s = dict(s)
        x = s["image"]
        x = T.adjust_brightness(x, rng.uniform(max(0, 1 - self.b), 1 + self.b))
        x = T.adjust_contrast(x, rng.uniform(max(0, 1 - self.c), 1 + self.c))
        x = T.adjust_saturation(x, rng.uniform(max(0, 1 - self.s), 1 + self.s))
        x = T.adjust_hue(x, rng.uniform(max(-0.5, -self.h), min(self.h, 0.5)))
        if self.gamma:
            g = rng.uniform(1, 1 + self.gamma)
            x = np.clip(x, 0, 1) ** g
        s["image"] = x.astype(np.float32)
        return s


class GaussianBlur:
    """Random-radius blur with prob `p`: radius ~ U(0, radius), drawn
    before the coin."""

    def __init__(self, radius=1.0, p=0.5):
        self.radius = radius
        self.p = p

    def __call__(self, s, rng):
        r = rng.uniform(0, self.radius)
        if rng.rand() > self.p:
            return s
        s = dict(s)
        img = Image.fromarray((s["image"] * 255).astype(np.uint8))
        img = img.filter(ImageFilter.GaussianBlur(r))
        s["image"] = np.asarray(img, np.float32) / 255.0
        return s


class NormalizeZeroMean:
    def __call__(self, s, rng):
        s = dict(s)
        s["image"] = (s["image"] - IMAGENET_MEAN) / IMAGENET_STD
        return s
