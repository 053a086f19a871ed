"""Segmentation datasets (`tripled_tpu/data/seg_datasets.py`): the KITTI
semseg benchmark and Cityscapes (directory layout), producing
{'image' (H,W,3) f32 normalized, 'label' (H,W) int32}, decoded with PIL.

`KittiSegmentation` splits `training/image_2` 80/20 into train and test by
a fixed permutation; `CityscapesSeg` reads `leftImg8bit/<split>/<city>/` and
`gtFine/<split>/<city>/*_gtFine_labelIds.png`. The test transform resizes
only the image (`Resize(only_img=True)`), so that a label keeps its source
size: `eval/segmentation_metrics.predict_labels` scores at that size.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from tripled_tpu_torch.data import seg_transforms as ST
from tripled_tpu_torch.data.seg_transforms import Compose


def _deterministic_split(n: int, train_frac: float = 0.8, seed: int = 0):
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    k = int(n * train_frac)
    return sorted(idx[:k]), sorted(idx[k:])


class KittiSegmentation:
    """KITTI semantic segmentation benchmark: `training/image_2` +
    `training/semantic`, deterministically split 80/20 train/test."""

    def __init__(self, data_path: str, split: str = "train", transform=None):
        self.data_path = data_path
        img_dir = os.path.join(data_path, "training", "image_2")
        self.img_dir = img_dir
        self.lab_dir = os.path.join(data_path, "training", "semantic")
        files = sorted(os.listdir(img_dir)) if os.path.isdir(img_dir) else []
        train_idx, test_idx = _deterministic_split(len(files))
        chosen = train_idx if split == "train" else test_idx
        self.files = [files[i] for i in chosen]
        self.transform = transform or Compose([])

    def __len__(self):
        return len(self.files)

    def sample(self, index: int, rng: np.random.RandomState) -> dict:
        fn = self.files[index]
        img = np.asarray(
            Image.open(os.path.join(self.img_dir, fn)).convert("RGB"), np.float32
        ) / 255.0
        lab_path = os.path.join(self.lab_dir, fn)
        label = (
            np.asarray(Image.open(lab_path)).astype(np.int32)
            if os.path.exists(lab_path)
            else None
        )
        s = self.transform({"image": img, "label": label}, rng)
        out = {"image": s["image"].astype(np.float32)}
        if s.get("label") is not None:
            out["label"] = s["label"].astype(np.int32)
        return out


class CityscapesSeg:
    """Cityscapes fine-annotation segmentation (leftImg8bit / gtFine)."""

    def __init__(self, data_path: str, split: str = "train", transform=None):
        self.img_root = os.path.join(data_path, "leftImg8bit", split)
        self.lab_root = os.path.join(data_path, "gtFine", split)
        items = []
        if os.path.isdir(self.img_root):
            for city in sorted(os.listdir(self.img_root)):
                for fn in sorted(os.listdir(os.path.join(self.img_root, city))):
                    if fn.endswith("_leftImg8bit.png"):
                        lab = fn.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                        items.append((city, fn, lab))
        self.items = items
        self.transform = transform or Compose([])

    def __len__(self):
        return len(self.items)

    def sample(self, index: int, rng: np.random.RandomState) -> dict:
        city, fn, lab = self.items[index]
        img = np.asarray(
            Image.open(os.path.join(self.img_root, city, fn)).convert("RGB"),
            np.float32,
        ) / 255.0
        lab_path = os.path.join(self.lab_root, city, lab)
        label = (
            np.asarray(Image.open(lab_path)).astype(np.int32)
            if os.path.exists(lab_path)
            else None
        )
        s = self.transform({"image": img, "label": label}, rng)
        out = {"image": s["image"].astype(np.float32)}
        if s.get("label") is not None:
            out["label"] = s["label"].astype(np.int32)
        return out


def get_segmentation_train_dataset(cfg, training: bool = True):
    """The training set of `cfg` (a DataConfig): KITTI semseg for `kitti`
    and `kitti_inpaint`, Cityscapes' train split for `cityscapes`."""
    if cfg.name in ("kitti", "kitti_inpaint"):
        tf = ST.Compose(
            [
                ST.RandomHorizontalFlip(0.5),
                ST.Resize((cfg.height, cfg.width)),
                ST.ConvertSegmentation(),
                ST.ColorJitter(0.2, 0.2, 0.2, 0.1, gamma=0.0, fraction=0.5),
                ST.NormalizeZeroMean(),
            ]
        )
        return KittiSegmentation(cfg.in_path, split="train", transform=tf)
    if cfg.name == "cityscapes":
        tf = ST.Compose(
            [
                ST.RandomHorizontalFlip(0.5),
                ST.Resize((512, 1024)),
                ST.RandomRescale(1.5),
                ST.RandomCrop((cfg.height, cfg.width)),
                ST.ConvertSegmentation(),
                ST.ColorJitter(0.2, 0.2, 0.2, 0.1, gamma=0.0, fraction=0.2),
                ST.NormalizeZeroMean(),
            ]
        )
        return CityscapesSeg(cfg.in_path, split="train", transform=tf)
    raise KeyError(cfg.name)


def get_test_segmentation_dataset(cfg, val: bool = True):
    """KITTI semseg's test part, or Cityscapes' `val` (or with `val=False`
    its `test`) split, the image resized to the config's size and the
    label kept at its own."""
    split = "val" if val else "test"
    tf = ST.Compose(
        [
            ST.Resize((cfg.height, cfg.width), only_img=True),
            ST.ConvertSegmentation(),
            ST.NormalizeZeroMean(),
        ]
    )
    if cfg.name in ("kitti", "kitti_inpaint"):
        return KittiSegmentation(cfg.in_path, split="test", transform=tf)
    if cfg.name == "cityscapes":
        return CityscapesSeg(cfg.in_path, split=split, transform=tf)
    raise KeyError(cfg.name)
