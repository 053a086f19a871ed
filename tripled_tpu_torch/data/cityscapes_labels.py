"""Cityscapes semantic-segmentation label table
(`tripled_tpu/data/cityscapes_labels.py`, public benchmark metadata).

19 train classes; all void/ignored classes map to train id 19 so the
segmentation head can predict an explicit void class (num_classes=20, as
`configs/cfg_kitti_fm_joint_inpaint_segmentation.py` sets it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

VOID_TRAIN_ID = 19


@dataclass(frozen=True)
class Label:
    name: str
    id: int
    trainId: int
    color: tuple


# name, id, trainId (255=void → VOID_TRAIN_ID at encode time), color
_RAW = [
    ("unlabeled", 0, 255, (0, 0, 0)),
    ("ego vehicle", 1, 255, (0, 0, 0)),
    ("rectification border", 2, 255, (0, 0, 0)),
    ("out of roi", 3, 255, (0, 0, 0)),
    ("static", 4, 255, (0, 0, 0)),
    ("dynamic", 5, 255, (111, 74, 0)),
    ("ground", 6, 255, (81, 0, 81)),
    ("road", 7, 0, (128, 64, 128)),
    ("sidewalk", 8, 1, (244, 35, 232)),
    ("parking", 9, 255, (250, 170, 160)),
    ("rail track", 10, 255, (230, 150, 140)),
    ("building", 11, 2, (70, 70, 70)),
    ("wall", 12, 3, (102, 102, 156)),
    ("fence", 13, 4, (190, 153, 153)),
    ("guard rail", 14, 255, (180, 165, 180)),
    ("bridge", 15, 255, (150, 100, 100)),
    ("tunnel", 16, 255, (150, 120, 90)),
    ("pole", 17, 5, (153, 153, 153)),
    ("polegroup", 18, 255, (153, 153, 153)),
    ("traffic light", 19, 6, (250, 170, 30)),
    ("traffic sign", 20, 7, (220, 220, 0)),
    ("vegetation", 21, 8, (107, 142, 35)),
    ("terrain", 22, 9, (152, 251, 152)),
    ("sky", 23, 10, (70, 130, 180)),
    ("person", 24, 11, (220, 20, 60)),
    ("rider", 25, 12, (255, 0, 0)),
    ("car", 26, 13, (0, 0, 142)),
    ("truck", 27, 14, (0, 0, 70)),
    ("bus", 28, 15, (0, 60, 100)),
    ("caravan", 29, 255, (0, 0, 90)),
    ("trailer", 30, 255, (0, 0, 110)),
    ("train", 31, 16, (0, 80, 100)),
    ("motorcycle", 32, 17, (0, 0, 230)),
    ("bicycle", 33, 18, (119, 11, 32)),
]

LABELS = [Label(*row) for row in _RAW]


def getlabels():
    return LABELS


def gettrainid2label():
    """trainId → Label for the 19 train classes + void."""
    out = {}
    for l in LABELS:
        if l.trainId != 255 and l.trainId not in out:
            out[l.trainId] = l
    out[VOID_TRAIN_ID] = Label("void", -1, VOID_TRAIN_ID, (0, 0, 0))
    return out


def id_to_trainid_lut() -> np.ndarray:
    """256-entry LUT mapping raw label ids to train ids (void → 19)."""
    lut = np.full(256, VOID_TRAIN_ID, np.uint8)
    for l in LABELS:
        tid = l.trainId if l.trainId != 255 else VOID_TRAIN_ID
        lut[l.id] = tid
    return lut


def num_train_classes(include_void: bool = True) -> int:
    return 20 if include_void else 19
