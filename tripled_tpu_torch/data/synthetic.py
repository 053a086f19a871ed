"""Synthetic mini-KITTI fixture (a copy of `tripled_tpu/data/synthetic.py`,
writing the same files bit for bit): an on-disk KITTI-raw-shaped tree
(images, calibration, velodyne, split files, gt_depths.npz), so that the
whole pipeline (loader, augmentation, training, Eigen evaluation) runs
without the real dataset."""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def _render_frame(t: float, h: int, w: int, rng: np.random.RandomState) -> np.ndarray:
    """A toy translating scene: gradient sky + textured moving blocks."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.stack(
        [
            0.3 + 0.4 * y / h,
            0.4 + 0.2 * np.sin((x + 40 * t) / 7.0),
            0.5 + 0.3 * np.cos((y + x + 25 * t) / 11.0),
        ],
        axis=-1,
    )
    for k in range(3):
        cx = int((0.2 + 0.3 * k) * w + 30 * t) % w
        cy = int((0.3 + 0.2 * k) * h)
        s = max(4, h // 6)
        img[max(0, cy - s) : cy + s, max(0, cx - s) : cx + s] = [
            0.2 + 0.25 * k,
            0.8 - 0.2 * k,
            0.4,
        ]
    img += rng.rand(h, w, 3) * 0.02
    return np.clip(img, 0, 1)


# --------------------------------------------------------- parallax scene
# A static, procedurally textured 3D scene rendered from a translating
# camera. Unlike `_render_frame` (uniform texture translation, which a pose
# alone explains, so that training on it collapses to constant disparity),
# pixel motion here is DEPTH-DEPENDENT, so
# self-supervised photometric training has a non-degenerate optimum and
# Eigen metrics on the analytic GT depth discriminate between arms.


def _tex(
    a: np.ndarray, b: np.ndarray, base, seed: int, fp=None
) -> np.ndarray:
    """Smooth band-limited RGB texture of two surface coordinates (meters).
    Multi-frequency sinusoids: detailed enough to localize, smooth enough
    that bilinear-warp gradients point the right way. `fp` is the per-pixel
    footprint in texture-coordinate units; each band is attenuated by a
    Gaussian mip factor exp(-0.5 (f·fp)²) so distant surfaces don't alias
    (point-sampled super-Nyquist texture breaks photometric consistency
    between views)."""
    r = np.random.RandomState(seed)
    img = np.empty(a.shape + (3,), np.float32)
    if fp is None:
        fp = np.float32(0.0)
    for c in range(3):
        freqs = (r.uniform(0.8, 1.6), r.uniform(2.5, 4.0), r.uniform(7.0, 11.0))
        amps = (0.22, 0.14, 0.08)
        phases = r.uniform(0, 6.28, 3)
        th = r.uniform(0, 3.14, 3)
        v = np.float32(0.0)
        for f, amp, p, t in zip(freqs, amps, phases, th):
            mip = np.exp(-0.5 * (f * fp) ** 2)
            v = v + amp * mip * np.sin(
                f * (np.cos(t) * a + np.sin(t) * b) + p
            )
        img[..., c] = base[c] + v
    return img


def _render_parallax(
    cam_pos: np.ndarray, h: int, w: int, fx: float, fy: float,
    cx: float, cy: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (image, depth) of the static scene from `cam_pos` (world
    meters, camera axes: x right, y down, z forward; no rotation).

    Scene: ground plane at y=+1.5 (KITTI-ish camera height), sky wall at
    z=cam+45, and fronto-parallel textured walls at staggered depths in two
    side lanes (regenerated periodically in z so any camera position sees
    walls 4-35 m ahead). Rays are parameterized as p + s*(dx, dy, 1), so
    s IS the camera-frame depth."""
    px, py, pz = float(cam_pos[0]), float(cam_pos[1]), float(cam_pos[2])
    u, v = np.meshgrid(
        np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32)
    )
    dx = (u - cx) / fx
    dy = (v - cy) / fy

    big = np.float32(1e9)
    # ground plane y = 1.5
    s_g = np.where(dy > 1e-6, (1.5 - py) / np.maximum(dy, 1e-6), big)
    depth = s_g.astype(np.float32)
    gx = px + s_g * dx  # ground hit world-x
    gz = pz + s_g      # ground hit world-z
    # footprint (m/px): across = s/fx; along-z grows as s²/((1.5-py)·fy)
    # at grazing angles — take the max
    g_fp = 0.9 * np.maximum(
        s_g / fx, s_g * s_g / (max(1.5 - py, 0.1) * fy)
    ).astype(np.float32)
    img = _tex(gx * 0.9, gz * 0.9, (0.45, 0.40, 0.35), seed=11, fp=g_fp)

    # sky wall 45 m ahead (keeps every pixel photometrically consistent
    # under pure translation while staying far = near-zero parallax)
    s_sky = np.float32(45.0)
    sky_mask = s_sky < depth
    wxs = px + s_sky * dx
    wys = py + s_sky * dy
    sky = _tex(
        wxs * 0.25, wys * 0.25, (0.55, 0.62, 0.72), seed=23,
        fp=np.float32(0.25 * 45.0 / fx),
    )
    img = np.where(sky_mask[..., None], sky, img)
    depth = np.where(sky_mask, s_sky, depth)

    # staggered walls: two side lanes + occasional mid obstacles, repeating
    # every `period` meters of z so the forward-moving camera always faces
    # some; nearest-hit composition over ~12 planes
    period = 9.0
    k0 = int(np.floor((pz + 2.0) / period))
    for k in range(k0, k0 + 5):
        zk = k * period
        for lane, (x0, x1, y0) in enumerate(
            (
                (-7.0, -2.5, -1.2),   # left wall band
                (2.5, 7.0, -0.8),     # right wall band
                (-1.0 + 2.0 * ((k % 3) - 1), 1.0 + 2.0 * ((k % 3) - 1), 0.2),
            )
        ):
            # de-align lanes so walls don't form a single fronto plane
            zkl = zk + 3.1 * lane + 1.7 * (k % 2)
            s_w = np.float32(zkl - pz)
            if s_w <= 0.5:
                continue
            wx = px + s_w * dx
            wy = py + s_w * dy
            hit = (
                (s_w < depth)
                & (wx >= x0) & (wx <= x1)
                & (wy >= y0) & (wy <= 1.5)
            )
            tex = _tex(wx * 1.3, wy * 1.3,
                       (0.35 + 0.25 * (lane == 1),
                        0.45 + 0.2 * (lane == 2),
                        0.55 - 0.15 * lane),
                       seed=101 + lane + 7 * (k % 4),
                       fp=np.float32(1.3 * float(s_w) / fx))
            img = np.where(hit[..., None], tex, img)
            depth = np.where(hit, s_w, depth)

    return np.clip(img, 0.0, 1.0), depth.astype(np.float32)


_PARALLAX_STEP = np.asarray([0.06, 0.0, 0.35], np.float32)  # m/frame


def _parallax_cam(i: int) -> np.ndarray:
    """Camera position of frame i: forward-dominant translation with a
    small lateral component (KITTI-like egomotion, translation-only)."""
    return i * _PARALLAX_STEP


def make_kitti_tree(
    root: str,
    num_frames: int = 8,
    height: int = 96,
    width: int = 320,
    date: str = "2011_09_26",
    drive: str = "2011_09_26_drive_0001_sync",
    seed: int = 0,
    scene: str = "translate",
) -> dict:
    """Create the tree and return paths dict with split-file locations.

    scene="translate": the original toy translating-texture frames (fast;
    fine for pipeline/IO tests, but self-supervised training on it
    collapses to constant disparity — pose alone explains the motion).
    scene="parallax": static textured 3D scene from a moving camera with
    analytic GT depth — depth-dependent pixel motion, so trajectory /
    Eigen studies discriminate."""
    rng = np.random.RandomState(seed)
    scene_dir = os.path.join(root, date, drive)
    for sub in ("image_02/data", "image_03/data", "velodyne_points/data"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)

    fx_, fy_ = 0.58 * width, 1.92 * height
    cx_, cy_ = 0.5 * width, 0.5 * height
    depths = {}
    for i in range(num_frames):
        if scene == "parallax":
            for cam, dx_st in (("image_02", 0.0), ("image_03", 0.54)):
                pos = _parallax_cam(i) + np.asarray([dx_st, 0, 0], np.float32)
                img_f, dep = _render_parallax(
                    pos, height, width, fx_, fy_, cx_, cy_
                )
                if cam == "image_02":
                    depths[i] = dep
                Image.fromarray((img_f * 255).astype(np.uint8)).save(
                    os.path.join(scene_dir, cam, "data", f"{i:010d}.png")
                )
        else:
            img = (_render_frame(i, height, width, rng) * 255).astype(np.uint8)
            for cam in ("image_02", "image_03"):
                Image.fromarray(img).save(
                    os.path.join(scene_dir, cam, "data", f"{i:010d}.png")
                )
        # sparse forward point cloud
        pts = np.zeros((256, 4), np.float32)
        pts[:, 0] = rng.uniform(3, 40, 256)   # forward
        pts[:, 1] = rng.uniform(-8, 8, 256)   # left
        pts[:, 2] = rng.uniform(-1.5, 1.5, 256)
        pts[:, 3] = 1.0
        pts.tofile(
            os.path.join(scene_dir, "velodyne_points/data", f"{i:010d}.bin")
        )

    # calibration (identity-ish rectification, fx/fy from normalized KITTI K)
    fx, fy = 0.58 * width, 1.92 * height
    cx, cy = 0.5 * width, 0.5 * height
    date_dir = os.path.join(root, date)
    with open(os.path.join(date_dir, "calib_cam_to_cam.txt"), "w") as f:
        eye3 = "1 0 0 0 1 0 0 0 1"
        f.write(f"R_rect_00: {eye3}\n")
        f.write(f"S_rect_02: {width} {height}\n")
        for cam in (2, 3):
            f.write(
                f"P_rect_0{cam}: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n"
            )
    with open(os.path.join(date_dir, "calib_velo_to_cam.txt"), "w") as f:
        # velodyne (fwd,left,up) -> camera (right,down,fwd)
        f.write("R: 0 -1 0 0 0 -1 1 0 0\n")
        f.write("T: 0 0 0\n")
    with open(os.path.join(date_dir, "calib_imu_to_velo.txt"), "w") as f:
        f.write("R: 1 0 0 0 1 0 0 0 1\nT: 0 0 0\n")

    # split files
    splits = os.path.join(root, "splits", "synthetic")
    os.makedirs(splits, exist_ok=True)
    rel = f"{date}/{drive}"
    train_lines = [f"{rel} {i} l" for i in range(1, num_frames - 1)]
    val_lines = [f"{rel} {i} l" for i in range(1, num_frames - 1)]
    with open(os.path.join(splits, "train_files.txt"), "w") as f:
        f.write("\n".join(train_lines) + "\n")
    with open(os.path.join(splits, "val_files.txt"), "w") as f:
        f.write("\n".join(val_lines) + "\n")

    # GT depths at native res: analytic per-pixel renderer depth for the
    # parallax scene; the legacy loose plane for the translate scene
    gt = []
    for i in range(1, num_frames - 1):
        if scene == "parallax":
            gt.append(depths[i])
        else:
            y = np.linspace(1, 0.2, height)[:, None]
            d = 5.0 / np.maximum(y, 0.05)
            gt.append(np.broadcast_to(d, (height, width)).astype(np.float32))
    gt_path = os.path.join(root, "gt_depths.npz")
    np.savez_compressed(gt_path, data=np.asarray(gt, dtype=object))

    return {
        "root": root,
        "scene": rel,
        "splits_dir": os.path.join(root, "splits"),
        "train_split": os.path.join(splits, "train_files.txt"),
        "val_split": os.path.join(splits, "val_files.txt"),
        "gt_depth_path": gt_path,
        "height": height,
        "width": width,
        "num_frames": num_frames,
    }


# ------------------------------------------------------- segmentation trees
# Not in the JAX package's synthetic.py: `make_kitti_seg_tree` writes what
# `tests/test_seg_train_cli.py` writes; `make_cityscapes_seg_tree` the
# Cityscapes directory layout.


def make_kitti_seg_tree(root: str, num_frames: int = 10, height: int = 64, width: int = 96,
                        seed: int = 0) -> str:
    """KITTI semseg layout: `training/image_2/<i>_10.png`, uniform noise
    frames, and `training/semantic/<i>_10.png`, raw ids drawn from 0-33 per
    pixel. Returns `root`."""
    img_dir = os.path.join(root, "training", "image_2")
    lab_dir = os.path.join(root, "training", "semantic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(num_frames):
        img = (rng.rand(height, width, 3) * 255).astype(np.uint8)
        lab = rng.randint(0, 34, (height, width)).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(img_dir, f"{i:06d}_10.png"))
        Image.fromarray(lab).save(os.path.join(lab_dir, f"{i:06d}_10.png"))
    return root


def make_cityscapes_seg_tree(root: str, frames=None, height: int = 1024, width: int = 2048,
                             block: int = 16, seed: int = 0, cities=("aachen", "bochum")) -> str:
    """Cityscapes layout: `leftImg8bit/<split>/<city>/<city>_<seq>_<frame>_leftImg8bit.png`
    and beside each `gtFine/<split>/<city>/..._gtFine_labelIds.png`, raw ids
    0-33 constant over `block` x `block` squares. `frames` maps each split to
    its frame count (default train 4, val 2, test 2), spread over `cities`.
    Each square of a frame takes its id's colour from a fixed palette, under
    a vertical gradient: a toy scene that PNG stores small and quickly (a
    real Cityscapes frame compresses far less). Returns `root`."""
    frames = frames or {"train": 4, "val": 2, "test": 2}
    rng = np.random.RandomState(seed)
    palette = rng.randint(0, 256, (34, 3)).astype(np.float32)
    shade = np.linspace(0, 60, height, dtype=np.float32)[:, None, None]
    for split, n in frames.items():
        for i in range(n):
            city = cities[i % len(cities)]
            stem = f"{city}_{i:06d}_000019"
            img_dir = os.path.join(root, "leftImg8bit", split, city)
            lab_dir = os.path.join(root, "gtFine", split, city)
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(lab_dir, exist_ok=True)
            ids = rng.randint(0, 34, (-(-height // block), -(-width // block))).astype(np.uint8)
            lab = ids.repeat(block, 0).repeat(block, 1)[:height, :width]
            img = np.clip(palette[lab] * 0.75 + shade, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(img_dir, f"{stem}_leftImg8bit.png"))
            Image.fromarray(lab).save(os.path.join(lab_dir, f"{stem}_gtFine_labelIds.png"))
    return root


# ------------------------------------------------ odometry and Make3D trees
# Not in the JAX package's synthetic.py either: the inputs of the odometry
# and Make3D evaluation entry points (`cli/eval_pose.py`,
# `cli/draw_odometry.py`, `cli/eval_make3d.py`).


def make_kitti_odom_tree(root: str, sequence: str = "09", num_frames: int = 12,
                         height: int = 96, width: int = 320, render_scale: int = 1) -> dict:
    """KITTI odometry layout: `sequences/<seq>/image_0/<i>.png`, the parallax
    scene seen along `_parallax_cam`; `splits/odom/test_files_<seq>.txt`,
    one `<seq> <i> l` line per frame that has a next one; and
    `poses/<seq>.txt`, the ground-truth camera-to-world poses in KITTI's
    3x4 format (no rotation, `_PARALLAX_STEP` a frame). With `render_scale`
    k > 1 each frame is rendered at 1/k of the size and resized to it
    (bilinear), k * k times quicker. Returns the paths."""
    img_dir = os.path.join(root, "sequences", sequence, "image_0")
    split_dir = os.path.join(root, "splits", "odom")
    pose_dir = os.path.join(root, "poses")
    for d in (img_dir, split_dir, pose_dir):
        os.makedirs(d, exist_ok=True)
    h, w = height // render_scale, width // render_scale
    fx, fy, cx, cy = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    with open(os.path.join(pose_dir, f"{sequence}.txt"), "w") as f:
        for i in range(num_frames):
            img, _ = _render_parallax(_parallax_cam(i), h, w, fx, fy, cx, cy)
            img = Image.fromarray((img * 255).astype(np.uint8))
            if (h, w) != (height, width):
                img = img.resize((width, height), Image.BILINEAR)
            img.save(os.path.join(img_dir, f"{i:06d}.png"))
            T = np.eye(4)[:3]
            T[:, 3] = _parallax_cam(i)
            f.write(" ".join(f"{v:.6e}" for v in T.reshape(-1)) + "\n")
    with open(os.path.join(split_dir, f"test_files_{sequence}.txt"), "w") as f:
        f.write("".join(f"{int(sequence)} {i} l\n" for i in range(num_frames - 1)))
    return {"root": root, "splits_dir": os.path.join(root, "splits"), "gt_poses_dir": pose_dir,
            "sequence": sequence, "num_frames": num_frames}


MAKE3D_IMAGE_SIZE = (1704, 2272)  # (W, H) of a Make3D Test134 image
MAKE3D_GRID = (55, 305)  # Position3DGrid's rows and columns


def make_make3d_tree(root: str, num_images: int = 3, seed: int = 0) -> str:
    """Make3D layout: `Test134/img-<name>.jpg` at 1704x2272 (W x H) and
    `Gridlaserdata/depth_sph_corr-<name>.mat`, whose (55, 305, 4)
    `Position3DGrid` holds x, y, z and the depth of each laser ray. Each
    image is the parallax scene from its own camera position, rendered at an
    eighth of the size and resized; the grid is the same scene's depth from
    the same camera over the same field of view, its top five rows at 80 m
    (beyond the protocol's 70 m cap). Returns `root`."""
    import scipy.io

    img_dir = os.path.join(root, "Test134")
    mat_dir = os.path.join(root, "Gridlaserdata")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mat_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    w, h = MAKE3D_IMAGE_SIZE[0] // 8, MAKE3D_IMAGE_SIZE[1] // 8
    gh, gw = MAKE3D_GRID
    f = 0.8 * w
    for k in range(num_images):
        cam = np.asarray([rng.uniform(-1, 1), rng.uniform(-0.3, 0.3), rng.uniform(0, 20)],
                         np.float32)
        img, _ = _render_parallax(cam, h, w, f, f, 0.5 * w, 0.5 * h)
        Image.fromarray((img * 255).astype(np.uint8)).resize(
            MAKE3D_IMAGE_SIZE, Image.BILINEAR).save(os.path.join(img_dir, f"img-{k:03d}.jpg"))
        fx, fy = f * gw / w, f * gh / h
        _, depth = _render_parallax(cam, gh, gw, fx, fy, 0.5 * gw, 0.5 * gh)
        depth[:5] = 80.0
        v, u = np.mgrid[0:gh, 0:gw].astype(np.float32)
        grid = np.stack([(u - 0.5 * gw) / fx * depth, (v - 0.5 * gh) / fy * depth, depth,
                         depth], -1)
        scipy.io.savemat(os.path.join(mat_dir, f"depth_sph_corr-{k:03d}.mat"),
                         {"Position3DGrid": grid.astype(np.float64)})
    return root
