"""Triplet-frame datasets (`tripled_tpu/data/datasets.py`), numpy on the
host. Each dataset gives one sample dict of fixed-shape arrays, stacked
over the frame axis in `frame_ids` order (index 0 is the target);
`pipeline.py` batches them.

Sample keys (a subset, by dataset):
  color, color_aug  (F, H, W, 3) float32 in [0, 1], or uint8 under
                    DataConfig.ship_uint8 (the model divides by 255)
  jitter_params     (9,) float32 in place of color_aug under
                    DataConfig.device_color_aug in training: the model
                    makes color_aug on the device (`ops/jitter.py`)
  K, inv_K          (4, 4)
  mask              (H, W, 1)   1 = keep, 0 = erased (inpaint datasets)
  map_mask          (F-1, H, W, 1) motion masks (map dataset)
  map_params        (F-1, 3)    (label, alpha1, alpha2) per source frame
  color_lab         (F, H, W, 3) with DataConfig.add_lab
  stereo_T          (4, 4)      when "s" is in frame_ids
  gt_depth          (h, w)      validation, at the ground truth's own size

Each draw from the sample's RandomState comes in the JAX package's order
(jitter?, flip?, the jitter's factors, the erase squares, then the
map-pose labels), so that
both packages make the same sample from the same seed.

Frames decode through the native loader (`native_loader.py`: g++, libpng,
libjpeg) unless TRIPLED_NATIVE_LOADER=0 or it did not build, and through
PIL when it is off or fails on a file, as in the JAX package. Both give
PIL's bytes after rounding; the native floats are those bytes times
1/255, which can differ from PIL's bytes / 255 in the last bit. Each
dataset counts its decodes by decoder in `counters` (`decodes_native`,
`decodes_pil`); the map dataset adds its motion masks' CPU seconds
(`motion_mask_cpu_s`). The training loop logs them each epoch.
"""

from __future__ import annotations

import datetime
import os
import threading
import time
from typing import Sequence

import numpy as np

from tripled_tpu_torch.config import DataConfig
from tripled_tpu_torch.data import kitti_utils, native_loader
from tripled_tpu_torch.data.transforms import (
    ColorJitter,
    load_image,
    make_erase_mask,
    motion_mask,
    resize_antialias,
    to_float,
)
from tripled_tpu_torch.ops.jitter import sample_jitter_params


class _DecodeCache:
    """Bounded in-RAM cache of decoded and resized frames, kept as uint8.
    PIL's resize gives uint8, so this is lossless for PIL, and the native
    loader's frames round to the same bytes: with the cache on, both
    decoders give the same sample. Frames are cached unflipped and mirrored
    on read (the native loader mirrors after its resize, so this is
    bit-identical). Insertion stops at the byte cap; thread-safe under the
    loader's worker pool."""

    def __init__(self, cap_bytes: int):
        self.cap = cap_bytes
        self.used = 0
        self._lock = threading.Lock()
        self._d: dict = {}

    def get(self, key):
        return self._d.get(key)

    def put(self, key, arr: np.ndarray) -> None:
        with self._lock:
            if key in self._d or self.used + arr.nbytes > self.cap:
                return
            self._d[key] = arr
            self.used += arr.nbytes


class MonoDataset:
    """Base triplet loader. Subclasses define `K_norm`, `full_res_shape`
    and `get_image_path`."""

    K_norm = np.array(
        [[0.58, 0, 0.5, 0], [0, 1.92, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    full_res_shape = (1242, 375)  # (W, H)

    def __init__(
        self,
        data_path: str,
        filenames: Sequence[str],
        height: int,
        width: int,
        frame_ids: Sequence,
        cfg: DataConfig | None = None,
        is_train: bool = False,
        img_ext: str = ".jpg",
        gt_depth_path: str | None = None,
    ):
        self.data_path = data_path
        self.filenames = list(filenames)
        self.height = height
        self.width = width
        self.frame_ids = tuple(frame_ids)
        self.cfg = cfg or DataConfig()
        self.is_train = is_train
        self.img_ext = img_ext
        self.jitter = ColorJitter()
        self.use_native = (os.environ.get("TRIPLED_NATIVE_LOADER", "1") == "1"
                           and native_loader.available())
        # frames decoded by each decoder (cache hits not counted), and a
        # subclass's own counts
        self.counters = {"decodes_native": 0, "decodes_pil": 0}
        self._count_lock = threading.Lock()
        if self.cfg.ship_uint8 and is_train and not self.cfg.device_color_aug:
            raise ValueError("DataConfig.ship_uint8 requires device_color_aug=True for training "
                             "datasets (the host ColorJitter needs float frames)")
        cap_mb = int(os.environ.get("TRIPLED_DECODE_CACHE_MB", str(self.cfg.decode_cache_mb)))
        self._decode_cache = _DecodeCache(cap_mb << 20) if cap_mb > 0 else None
        self.gt_depths = None
        if not is_train and gt_depth_path:
            self.gt_depths = np.load(gt_depth_path, allow_pickle=True, fix_imports=True,
                                     encoding="latin1")["data"]

    def __len__(self):
        return len(self.filenames)

    # -------------------------------------------------------- subclass API

    def get_image_path(self, folder, frame_index, side) -> str:
        raise NotImplementedError

    def get_color(self, folder, frame_index, side, do_flip):
        img = load_image(self.get_image_path(folder, frame_index, side))
        if do_flip:
            img = img.transpose(0)  # PIL FLIP_LEFT_RIGHT
        return img

    # -------------------------------------------------------- sample

    def parse_line(self, index):
        line = self.filenames[index].split()
        folder = line[0]
        frame_index = int(line[1]) if len(line) == 3 else 0
        side = line[2] if len(line) == 3 else None
        return folder, frame_index, side

    def _load_resized(self, folder, frame_index, side, do_flip, as_uint8=False) -> np.ndarray:
        """One frame as float32 (H, W, 3) in [0, 1], or uint8 when
        `as_uint8`, resized and optionally flipped, through the decode cache
        when it is on. Cache fills and uint8 frames are rounded as
        rint(x * 255), so they sit on PIL's uint8 grid whichever decoder
        ran."""
        cache = self._decode_cache
        if cache is None:
            dec = self._decode(folder, frame_index, side, do_flip)
            return np.rint(dec * 255.0).astype(np.uint8) if as_uint8 else dec
        key = self.get_image_path(folder, frame_index, side)
        hit = cache.get(key)
        if hit is None:
            hit = np.rint(self._decode(folder, frame_index, side, False) * 255.0).astype(np.uint8)
            cache.put(key, hit)
        img = hit if as_uint8 else hit.astype(np.float32) / 255.0
        return img[:, ::-1] if do_flip else img

    def _count(self, key: str, amount=1) -> None:
        with self._count_lock:
            self.counters[key] += amount

    def _decode(self, folder, frame_index, side, do_flip) -> np.ndarray:
        """The native loader first, then PIL where it is off or fails."""
        if self.use_native:
            try:
                img = native_loader.load_image(self.get_image_path(folder, frame_index, side),
                                               self.height, self.width, flip=do_flip)
            except IOError:
                pass
            else:
                self._count("decodes_native")
                return img
        img = self.get_color(folder, frame_index, side, do_flip)
        self._count("decodes_pil")
        return to_float(resize_antialias(img, self.height, self.width))

    def load_frames(self, index, do_flip):
        """The sample's frames; a missing neighbour falls back to the
        centre frame."""
        folder, frame_index, side = self.parse_line(index)
        u8 = self.cfg.ship_uint8
        frames = []
        for i in self.frame_ids:
            if i == "s":
                other = {"r": "l", "l": "r"}[side]
                frames.append(self._load_resized(folder, frame_index, other, do_flip, u8))
            else:
                try:
                    frames.append(self._load_resized(folder, frame_index + i, side, do_flip, u8))
                except Exception:
                    frames.append(self._load_resized(folder, frame_index, side, do_flip, u8))
        return frames, side

    def sample(self, index: int, rng: np.random.RandomState) -> dict:
        do_color_aug = self.is_train and rng.rand() > 0.5
        do_flip = self.is_train and rng.rand() > 0.5

        frames, side = self.load_frames(index, do_flip)
        colors = np.stack(frames)  # (F, H, W, 3) float32 in [0, 1], or uint8
        u8 = colors.dtype == np.uint8
        jitter_params = None
        if self.is_train and self.cfg.device_color_aug:
            jitter_params = sample_jitter_params(rng, self.jitter, do_color_aug)
        elif do_color_aug:
            aug = self.jitter.sample(rng)
            color_aug = np.stack([aug(c) for c in colors])
        else:
            color_aug = colors.copy()

        K = self.K_norm.copy()
        K[0, :] *= self.width
        K[1, :] *= self.height
        inv_K = np.linalg.pinv(K).astype(np.float32)

        out = {
            "color": colors if u8 else colors.astype(np.float32),
            "K": K.astype(np.float32),
            "inv_K": inv_K,
        }
        if jitter_params is not None:
            out["jitter_params"] = jitter_params
        else:
            out["color_aug"] = color_aug if u8 else color_aug.astype(np.float32)
        if self.cfg.add_lab:
            # PIL ImageCms Lab of each frame, scaled to [0, 1] per channel as
            # a uint8 Lab image is
            from PIL import Image, ImageCms

            tf = ImageCms.buildTransformFromOpenProfiles(
                ImageCms.createProfile("sRGB"), ImageCms.createProfile("LAB"), "RGB", "LAB")
            labs = [np.asarray(ImageCms.applyTransform(
                Image.fromarray(c if u8 else (c * 255).astype(np.uint8)), tf),
                np.float32) / 255.0
                for c in colors]
            out["color_lab"] = np.stack(labs)
        if "s" in self.frame_ids:
            stereo_T = np.eye(4, dtype=np.float32)
            baseline_sign = -1 if do_flip else 1
            side_sign = -1 if side == "l" else 1
            stereo_T[0, 3] = side_sign * baseline_sign * 0.015
            out["stereo_T"] = stereo_T

        self.post_process(out, rng)

        if self.gt_depths is not None:
            out["gt_depth"] = np.asarray(self.gt_depths[index], np.float32)
        return out

    def post_process(self, out: dict, rng: np.random.RandomState) -> None:
        """Hook for masks and pretext extras."""


class KITTIRawDataset(MonoDataset):
    side_map = {"2": 2, "3": 3, "l": 2, "r": 3}

    def get_image_path(self, folder, frame_index, side):
        f_str = f"{frame_index:010d}{self.img_ext}"
        return os.path.join(self.data_path, folder, f"image_0{self.side_map[side]}/data", f_str)

    def get_depth(self, folder, frame_index, side, do_flip):
        """The sparse depth map (H, W) of the frame's velodyne scan,
        projected into the side's camera (`kitti_utils.generate_depth_map`)."""
        calib_path = os.path.join(self.data_path, folder.split("/")[0])
        velo = os.path.join(self.data_path, folder,
                            f"velodyne_points/data/{int(frame_index):010d}.bin")
        depth = kitti_utils.generate_depth_map(calib_path, velo, self.side_map[side])
        if do_flip:
            depth = np.fliplr(depth)
        return depth

    def get_pose(self, folder, frame_index, offset):
        """OXTS speed-integrated relative displacement in the rectified cam
        frame (`kitti_dataset.py:220-243`)."""
        oxts_root = os.path.join(self.data_path, folder, "oxts")
        with open(os.path.join(oxts_root, "timestamps.txt")) as f:
            timestamps = np.array([
                datetime.datetime.strptime(ts[:-3], "%Y-%m-%d %H:%M:%S.%f").timestamp()
                for ts in f.read().splitlines()])
        speed0 = np.genfromtxt(
            os.path.join(oxts_root, "data", f"{frame_index:010d}.txt"))[[8, 9, 10]]
        dt = timestamps[frame_index + offset] - timestamps[frame_index]
        displacement = speed0 * dt
        root = os.path.join(self.data_path, os.path.dirname(folder))
        imu2velo = kitti_utils.read_calib_file(os.path.join(root, "calib_imu_to_velo.txt"))
        velo2cam = kitti_utils.read_calib_file(os.path.join(root, "calib_velo_to_cam.txt"))
        cam2cam = kitti_utils.read_calib_file(os.path.join(root, "calib_cam_to_cam.txt"))
        velo2cam_mat = kitti_utils.transform_from_rot_trans(velo2cam["R"], velo2cam["T"])
        imu2velo_mat = kitti_utils.transform_from_rot_trans(imu2velo["R"], imu2velo["T"])
        rect = kitti_utils.transform_from_rot_trans(cam2cam["R_rect_00"], np.zeros(3))
        imu2cam = rect @ velo2cam_mat @ imu2velo_mat
        return imu2cam[:3, :3] @ displacement + imu2cam[:3, 3]


class KITTIInpaintDataset(KITTIRawDataset):
    def post_process(self, out, rng):
        out["mask"] = make_erase_mask(rng, self.height, self.width, self.cfg.erase_shape,
                                      self.cfg.erase_count)


class KITTIMapDataset(KITTIInpaintDataset):
    """The inpaint mask, then per source frame its motion mask against the
    target and map-pose params (label, alpha1, alpha2): the label drawn
    from `rng` over the len(alphas)**2 alpha pairs, in the JAX package's
    order of draws (`tripled_tpu/data/datasets.py:384-401`). The alphas
    default to (0.25, 0.5, 0.75, 1.0). A validation sample, target only,
    has neither: the JAX package stacks no masks there and raises, so its
    eval hook cannot run on this dataset. `counters["motion_mask_cpu_s"]`
    sums the CPU time of each `motion_mask` call on its own thread, so
    that BatchLoader's threads waiting for one another do not count."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.counters["motion_mask_cpu_s"] = 0.0

    def post_process(self, out, rng):
        super().post_process(out, rng)
        if len(self.frame_ids) == 1:
            return
        alphas = tuple(self.cfg.map_alphas) or (0.25, 0.5, 0.75, 1.0)
        target = out["color"][0]
        masks, params = [], []
        for i in range(1, len(self.frame_ids)):
            t0 = time.thread_time()
            masks.append(motion_mask(target, out["color"][i]))
            self._count("motion_mask_cpu_s", time.thread_time() - t0)
            gt_map = rng.randint(0, len(alphas) ** 2)
            ind1, ind2 = gt_map // len(alphas), gt_map % len(alphas)
            params.append([float(gt_map), alphas[ind1], alphas[ind2]])
        out["map_mask"] = np.stack(masks).astype(np.float32)
        out["map_params"] = np.asarray(params, np.float32)


class KITTIOdomDataset(MonoDataset):
    K_norm = KITTIRawDataset.K_norm

    def get_image_path(self, folder, frame_index, side):
        side_map = {"l": 0, "r": 1}
        return os.path.join(self.data_path, f"sequences/{int(folder):02d}",
                            f"image_{side_map[side]}", f"{frame_index:06d}{self.img_ext}")


class KITTIDepthDataset(KITTIRawDataset):
    """KITTI raw frames with the improved png ground-truth depth maps
    (`kitti_dataset.py:341-371`), resized to `full_res_shape` by PIL's
    nearest neighbour as the JAX package resizes them."""

    def get_depth(self, folder, frame_index, side, do_flip):
        from PIL import Image

        p = os.path.join(self.data_path, folder,
                         f"proj_depth/groundtruth/image_0{self.side_map[side]}",
                         f"{frame_index:010d}.png")
        depth = Image.open(p).resize(self.full_res_shape, Image.NEAREST)
        depth = np.asarray(depth, np.float32) / 256.0
        if do_flip:
            depth = np.fliplr(depth)
        return depth


class FolderDataset(MonoDataset):
    """Plain image directory: the sorted files are the frames."""

    K_norm = np.array(
        [[0.9765, 0, 0.5, 0], [0, 1.736, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

    def __init__(self, data_path, filenames=None, **kw):
        files = sorted(os.listdir(data_path))
        super().__init__(data_path, files, **kw)

    def parse_line(self, index):
        return self.filenames[index], index, None

    def get_image_path(self, folder, frame_index, side):
        idx = min(max(frame_index, 0), len(self.filenames) - 1)
        return os.path.join(self.data_path, self.filenames[idx])

    def load_frames(self, index, do_flip):
        frames = []
        for i in self.frame_ids:
            j = min(max(index + (i if i != "s" else 0), 0), len(self.filenames) - 1)
            frames.append(self._load_resized(None, j, None, do_flip))
        return frames, None


class ETH3DDataset(FolderDataset):
    K_norm = np.array(
        [[0.9832, 0, 0.5, 0], [0, 1.736, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


class EuRoCDataset(FolderDataset):
    # fx/w, fy/h of the EuRoC cam0 calibration
    K_norm = np.array(
        [[458.654 / 752, 0, 0.5, 0], [0, 457.296 / 480, 0.5, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
        np.float32)
