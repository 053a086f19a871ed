"""The port's numpy evaluation modules against the JAX package's, on the
same float64 inputs from a numpy seed: `tools/*`, `eval/pose.py`,
`eval/odometry.py`, `data/kitti_utils.py`, `eval/make3d.py`,
`KITTIRawDataset.get_depth` and `get_pose`, `KITTIDepthDataset`; and the
stereo frame, whose `stereo_T` the datasets and `random_train_inputs`
give, through a model's training forward. About 20 s on one CPU worker
(pytest's seconds, the plot suite most of it).

Tolerance: the port's modules are copies of the JAX package's plain numpy,
so every value is held equal (`assert_array_equal`), and every file the
two write equal byte for byte. The odometry suite runs on a 400-pose
trajectory at about 2.2 m a frame with a slow yaw, 880 m, so that every
segment length from 100 to 800 m has segments (a short one gives the nan
of an empty list and holds nothing). The one deliberate difference: the
port's `evaluate_odometry` says in its result whether it wrote the plots,
and writes none where matplotlib is not installed.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import tripled_tpu.tools as jax_tools
from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.data import datasets as jax_datasets
from tripled_tpu.data import kitti_utils as jax_kitti_utils
from tripled_tpu.eval import make3d as jax_make3d
from tripled_tpu.eval import odometry as jax_odometry
from tripled_tpu.eval import pose as jax_pose
from tripled_tpu.tools import transformations as jax_transformations
import tripled_tpu_torch.tools as tools
from tripled_tpu_torch.config import DataConfig, ModelConfig
from tripled_tpu_torch.data import datasets, kitti_utils
from tripled_tpu_torch.data.synthetic import make_kitti_tree, make_make3d_tree
from tripled_tpu_torch.eval import make3d, odometry, pose
from tripled_tpu_torch.tools import transformations

torch.set_num_threads(1)


def _eq(a, b):
    """Equal values, the same nesting of tuples, lists and dicts."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _rotations(rng, n):
    return [tools.so3_exp(rng.randn(3) * s) for s in np.linspace(0.1, 3.0, n)]


def _poses(rng, n):
    out = []
    for R in _rotations(rng, n):
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.randn(3) * 5
        out.append(T)
    return np.asarray(out)


# ------------------------------------------------------------------ tools


def test_tools_export_the_jax_names():
    names = [n for n in dir(jax_tools) if not n.startswith("_")]
    assert [n for n in dir(tools) if not n.startswith("_")] == names


def test_lie_matches_jax():
    rng = np.random.RandomState(0)
    ws = [rng.randn(3) * s for s in (1e-12, 1e-3, 0.5, 2.0, 3.1)] + [np.array([np.pi, 0, 0])]
    for w in ws:
        for name in ("hat", "so3_exp", "_left_jacobian"):
            _eq(getattr(tools.lie, name)(w), getattr(jax_tools.lie, name)(w))
        R = jax_tools.so3_exp(w)
        _eq(tools.so3_log(R), jax_tools.so3_log(R))
        _eq(tools.vee(R), jax_tools.vee(R))
        _eq(tools.is_so3(R), jax_tools.is_so3(R))
        xi = np.concatenate([rng.randn(3), w])
        T = jax_tools.se3_exp(xi)
        _eq(tools.se3_exp(xi), T)
        _eq(tools.se3_log(T), jax_tools.se3_log(T))
        _eq(tools.is_se3(T), jax_tools.is_se3(T))
        _eq(tools.sim3(R, xi[:3], 1.7), jax_tools.sim3(R, xi[:3], 1.7))
    near_pi = jax_tools.so3_exp(np.array([np.pi - 1e-7, 1e-3, -2e-3]))
    _eq(tools.so3_log(near_pi), jax_tools.so3_log(near_pi))
    assert not tools.is_so3(2 * np.eye(3)) and not tools.is_se3(2 * np.eye(4))


def test_trajectory_matches_jax():
    rng = np.random.RandomState(1)
    model = rng.randn(50, 3) * 10
    R = tools.so3_exp(np.array([0.1, -0.4, 0.3]))
    data = (model @ R.T) * 0.7 + rng.randn(3) + rng.randn(50, 3) * 0.01
    for known in (False, True):
        _eq(tools.align_umeyama(model, data, known), jax_tools.align_umeyama(model, data, known))
    for method in ("sim3", "se3", "posyaw"):
        for n in (-1, 20):
            _eq(tools.align_trajectory(model, data, method, n),
                jax_tools.align_trajectory(model, data, method, n))
    with pytest.raises(ValueError):
        tools.align_trajectory(model, data, "nope")
    poses = _poses(rng, 30)
    path, jax_path = tools.PosePath3D(poses), jax_tools.PosePath3D(poses)
    _eq(path.positions, jax_path.positions)
    _eq(path.distances, jax_path.distances)
    T = poses[3]
    _eq(path.transform(T, 1.3).poses, jax_path.transform(T, 1.3).poses)
    other = poses[::-1].copy()
    _eq(path.ape_rmse(tools.PosePath3D(other)), jax_path.ape_rmse(jax_tools.PosePath3D(other)))


def test_transformations_match_jax():
    rng = np.random.RandomState(2)
    gimbal = jax_transformations.euler_matrix(0.3, np.pi / 2, 0.2)
    szxy_gimbal = np.eye(4)
    szxy_gimbal[:3, :3] = [[0, 1, 0], [0, 0, -1], [-1, 0, 0]]
    for M in list(_poses(rng, 12)) + [np.eye(4), gimbal, szxy_gimbal,
                                      np.diag([-1.0, -1.0, 1.0, 1.0]),
                                      np.diag([-1.0, 1.0, -1.0, 1.0]),
                                      np.diag([1.0, -1.0, -1.0, 1.0])]:
        q = jax_transformations.quaternion_from_matrix(M)
        _eq(transformations.quaternion_from_matrix(M), q)
        _eq(transformations.quaternion_matrix(q), jax_transformations.quaternion_matrix(q))
        e = jax_transformations.euler_from_matrix(M)
        _eq(transformations.euler_from_matrix(M), e)
        _eq(transformations.euler_matrix(*e), jax_transformations.euler_matrix(*e))
        _eq(transformations.quaternion_from_euler(*e),
            jax_transformations.quaternion_from_euler(*e))
        _eq(transformations.euler_from_quaternion(q), jax_transformations.euler_from_quaternion(q))
        # the odometry plot's convention, held here against the JAX module
        _eq(transformations.euler_from_matrix_szxy(M),
            jax_transformations.euler_from_matrix_szxy(M))


def test_file_interface_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    poses = _poses(rng, 8)
    stamps = np.cumsum(rng.rand(8))
    for fmt in ("tum", "kitti"):
        args = (stamps, poses) if fmt == "tum" else (poses,)
        getattr(tools, f"write_{fmt}_" + ("trajectory" if fmt == "tum" else "poses"))(
            str(tmp_path / f"port.{fmt}"), *args)
        getattr(jax_tools, f"write_{fmt}_" + ("trajectory" if fmt == "tum" else "poses"))(
            str(tmp_path / f"jax.{fmt}"), *args)
        assert (tmp_path / f"port.{fmt}").read_bytes() == (tmp_path / f"jax.{fmt}").read_bytes()
    (tmp_path / "port.tum").write_text("# header\n\n" + (tmp_path / "port.tum").read_text())
    _eq(tools.read_tum_trajectory(str(tmp_path / "port.tum")),
        jax_tools.read_tum_trajectory(str(tmp_path / "port.tum")))
    _eq(tools.read_kitti_poses(str(tmp_path / "port.kitti")),
        jax_tools.read_kitti_poses(str(tmp_path / "port.kitti")))
    q = rng.randn(8, 4)
    rows = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z", ""] + [
        ",".join([str(int(t * 1e9))] + [repr(float(v)) for v in np.r_[rng.randn(3), qi]])
        for t, qi in zip(stamps, q)]
    (tmp_path / "euroc.csv").write_text("\n".join(rows) + "\n")
    _eq(tools.read_euroc_trajectory(str(tmp_path / "euroc.csv")),
        jax_tools.read_euroc_trajectory(str(tmp_path / "euroc.csv")))
    other = stamps + rng.uniform(-0.03, 0.03, 8)
    pairs = tools.associate_timestamps(stamps, other)
    assert pairs == jax_tools.associate_timestamps(stamps, other) and pairs
    assert tools.associate_timestamps(stamps, other, 0.5) == jax_tools.associate_timestamps(
        stamps, other, 0.5)


# ------------------------------------------------------------- eval/pose


def test_pose_eval_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    gt = _poses(rng, 24)
    pred = np.asarray([np.linalg.inv(gt[i]) @ gt[i + 1] for i in range(23)])
    pred[:, :3, 3] *= 0.8
    pred[:, :3, :] += rng.randn(23, 3, 4) * 1e-2
    _eq(pose.dump_xyz(pred), jax_pose.dump_xyz(pred))
    a, b = gt[:5, :3, 3], pred[:5, :3, 3]
    _eq(pose.compute_ate(a, b), jax_pose.compute_ate(a, b))
    for track in (3, 5):
        _eq(pose.evaluate_pose_ate(pred, gt, track), jax_pose.evaluate_pose_ate(pred, gt, track))
    _eq(pose.accumulate_global_poses(pred), jax_pose.accumulate_global_poses(pred))
    pose.save_kitti_poses(str(tmp_path / "port.txt"), gt)
    jax_pose.save_kitti_poses(str(tmp_path / "jax.txt"), gt)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    _eq(pose.load_kitti_poses(str(tmp_path / "port.txt")),
        jax_pose.load_kitti_poses(str(tmp_path / "port.txt")))


# --------------------------------------------------------- eval/odometry


def _drive(n=400, seed=5):
    """A ground-truth drive of n poses at about 2.2 m a frame (80 km/h at
    KITTI's 10 Hz) with a slow yaw and a little pitch, 880 m in all, and a
    prediction with drift, a scale and noise."""
    rng = np.random.RandomState(seed)
    gt, pred = [np.eye(4)], [np.eye(4)]
    for i in range(1, n):
        step = np.eye(4)
        step[:3, :3] = tools.so3_exp(np.array([0.002 * np.sin(i / 30), 0.005, 0.0]))
        step[:3, 3] = [0.02 * np.sin(i / 17), 0.0, 2.2 + 0.2 * np.sin(i / 50)]
        noisy = step.copy()
        noisy[:3, :3] = step[:3, :3] @ tools.so3_exp(rng.randn(3) * 1e-3)
        noisy[:3, 3] = 0.6 * (step[:3, 3] + rng.randn(3) * 0.02)
        gt.append(gt[-1] @ step)
        pred.append(pred[-1] @ noisy)
    return np.asarray(gt), np.asarray(pred)


def test_segment_errors_match_jax():
    gt, pred = _drive()
    _eq(odometry.trajectory_distances(gt), jax_odometry.trajectory_distances(gt))
    aligned = odometry.scale_optimize(gt, pred)
    _eq(aligned, jax_odometry.scale_optimize(gt, pred))
    errors = odometry.calc_sequence_errors(gt, aligned)
    jax_errors = jax_odometry.calc_sequence_errors(gt, aligned)
    assert [dataclasses.astuple(e) for e in errors] == [dataclasses.astuple(e)
                                                          for e in jax_errors]
    assert {e.length for e in errors} == set(odometry.SEGMENT_LENGTHS)
    T = np.eye(4)
    T[:3, :3] = tools.so3_exp(np.array([0.1, 0.2, -0.3]))
    T[:3, 3] = [1, 2, 3]
    _eq(odometry.rotation_error(T), jax_odometry.rotation_error(T))
    _eq(odometry.translation_error(T), jax_odometry.translation_error(T))
    per_length = odometry.per_length_errors(errors)
    _eq(per_length, jax_odometry.per_length_errors(jax_errors))
    assert sorted(per_length) == list(odometry.SEGMENT_LENGTHS)
    per_speed = odometry.per_speed_errors(errors)
    _eq(per_speed, jax_odometry.per_speed_errors(jax_errors))
    assert per_speed
    _eq(odometry.average_segment_errors(errors), jax_odometry.average_segment_errors(jax_errors))
    _eq(odometry.average_segment_errors([]), jax_odometry.average_segment_errors([]))
    assert odometry.per_speed_errors([]) == {}


def _files(d):
    return sorted(os.listdir(d))


def test_evaluate_odometry_matches_jax(tmp_path):
    gt, pred = _drive()
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    result = odometry.evaluate_odometry(gt, pred, out_dir=str(port_dir), seq_name="09")
    want = jax_odometry.evaluate_odometry(gt, pred, out_dir=str(jax_dir), seq_name="09")
    assert result.pop("plots_written") is True
    _eq(result, want)
    assert all(np.isfinite(result[k]) for k in ("t_err_percent", "r_err_deg_per_m", "ate_rmse"))
    assert _files(port_dir) == _files(jax_dir)
    assert len(_files(port_dir)) == 2 + 2 * 4 + 2  # stats, errors; 4 plots x png, pdf; 2 curves
    for name in ("09_stats.txt", "09_seq_errors.txt"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()
    _eq(odometry.evaluate_odometry(gt, pred, align_scale=False),
        jax_odometry.evaluate_odometry(gt, pred, align_scale=False))


def test_evaluate_odometry_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is not installed: the stats and segment errors, no
    plots, and the result says so."""
    gt, pred = _drive(n=40)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    result = odometry.evaluate_odometry(gt, pred, out_dir=str(tmp_path), seq_name="10")
    assert result["plots_written"] is False
    assert _files(tmp_path) == ["10_seq_errors.txt", "10_stats.txt"]
    # too short for a 100 m segment: the nan of an empty list, as in JAX
    assert np.isnan(result["t_err_percent"]) and not (tmp_path / "10_seq_errors.txt").read_text()


# --------------------------------------------------------- kitti_utils


def test_kitti_utils_match_jax(tmp_path):
    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=3, height=48, width=160)
    calib_dir = os.path.join(tree["root"], "2011_09_26")
    for name in ("calib_cam_to_cam.txt", "calib_velo_to_cam.txt"):
        path = os.path.join(calib_dir, name)
        _eq(kitti_utils.read_calib_file(path), jax_kitti_utils.read_calib_file(path))
    with open(os.path.join(calib_dir, "calib_cam_to_cam.txt"), "a") as f:
        f.write("calib_time: 09-Jan-2012 13:57:47\nno colon here\n")
    path = os.path.join(calib_dir, "calib_cam_to_cam.txt")
    _eq(kitti_utils.read_calib_file(path), jax_kitti_utils.read_calib_file(path))
    velo = os.path.join(tree["root"], tree["scene"], "velodyne_points/data/0000000001.bin")
    _eq(kitti_utils.load_velodyne_points(velo), jax_kitti_utils.load_velodyne_points(velo))
    for cam in (2, 3):
        _eq(kitti_utils.velo_to_image_projection(calib_dir, cam),
            jax_kitti_utils.velo_to_image_projection(calib_dir, cam))
        for vel_depth in (False, True):
            depth = kitti_utils.generate_depth_map(calib_dir, velo, cam, vel_depth)
            _eq(depth, jax_kitti_utils.generate_depth_map(calib_dir, velo, cam, vel_depth))
            assert (depth > 0).sum() > 20
    for t in (-0.7, 0.0, 1.3):
        for name in ("rotx", "roty", "rotz"):
            _eq(getattr(kitti_utils, name)(t), getattr(jax_kitti_utils, name)(t))
    R, t = np.random.RandomState(6).randn(9), [1.0, 2.0, 3.0]
    _eq(kitti_utils.transform_from_rot_trans(R, t), jax_kitti_utils.transform_from_rot_trans(R, t))
    for packet, scale in (((49.0, 8.4, 112.0, 0.01, -0.02, 1.5), 0.656),
                          ((-33.9, 151.2, 5.0, 0.2, 0.1, -2.0), 0.83)):
        _eq(kitti_utils.pose_from_oxts_packet(packet, scale),
            jax_kitti_utils.pose_from_oxts_packet(packet, scale))


def test_min_depth_duplicates_match_jax(tmp_path):
    """Velodyne returns that project into one pixel: both keep the nearest."""
    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=3, height=48, width=160)
    calib_dir = os.path.join(tree["root"], "2011_09_26")
    rng = np.random.RandomState(7)
    base = np.stack([rng.uniform(3, 40, 100), rng.uniform(-5, 5, 100),
                     rng.uniform(-1, 1, 100)], -1)
    pts = np.ones((300, 4), np.float32)
    # three returns along each ray, a little nearer and farther
    pts[:, :3] = np.repeat(base, 3, 0) * np.tile([1.0, 1.001, 0.999], 100)[:, None]
    velo = str(tmp_path / "dup.bin")
    pts.tofile(velo)
    depth = kitti_utils.generate_depth_map(calib_dir, velo)
    _eq(depth, jax_kitti_utils.generate_depth_map(calib_dir, velo))
    assert 0 < (depth > 0).sum() < 300


# ---------------------------------------------------- get_depth, get_pose


def _oxts(scene_dir, n, rng):
    """An `oxts/` folder of n packets with KITTI's nanosecond time stamps."""
    os.makedirs(os.path.join(scene_dir, "oxts", "data"), exist_ok=True)
    with open(os.path.join(scene_dir, "oxts", "timestamps.txt"), "w") as f:
        for i in range(n):
            f.write(f"2011-09-26 13:02:{25 + i // 10:02d}.{(i % 10) * 103_456_789 + 1:09d}\n")
    for i in range(n):
        np.savetxt(os.path.join(scene_dir, "oxts", "data", f"{i:010d}.txt"),
                   rng.randn(1, 30), fmt="%.10f")


def _dataset_pair(cls, tree, **kw):
    args = dict(data_path=tree["root"], filenames=[f"{tree['scene']} {i} l" for i in (1, 2)],
                height=48, width=160, frame_ids=(0, -1, 1), img_ext=".png", **kw)
    jax_cls = getattr(jax_datasets, cls)
    return (getattr(datasets, cls)(cfg=DataConfig(), **args),
            jax_cls(cfg=JaxDataConfig(), **args))


def test_get_depth_and_get_pose_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")
    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=5, height=48, width=160)
    _oxts(os.path.join(tree["root"], tree["scene"]), 5, np.random.RandomState(8))
    ds, jax_ds = _dataset_pair("KITTIRawDataset", tree)
    for frame in (1, 3):
        for side in ("l", "r"):
            for flip in (False, True):
                depth = ds.get_depth(tree["scene"], frame, side, flip)
                _eq(depth, jax_ds.get_depth(tree["scene"], frame, side, flip))
        for offset in (-1, 1):
            _eq(ds.get_pose(tree["scene"], frame, offset),
                jax_ds.get_pose(tree["scene"], frame, offset))
    assert np.abs(ds.get_pose(tree["scene"], 3, 1)).max() > 0


def test_kitti_depth_dataset_matches_jax(tmp_path, monkeypatch):
    """The improved ground truth, uint16 PNGs at another size than
    `full_res_shape`, resized by nearest neighbour bit for bit; samples
    equal to the JAX dataset's."""
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")
    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=4, height=48, width=160)
    rng = np.random.RandomState(9)
    for cam in ("image_02", "image_03"):
        d = os.path.join(tree["root"], tree["scene"], "proj_depth/groundtruth", cam)
        os.makedirs(d)
        for i in range(4):
            depth = (rng.rand(370, 1224) < 0.05) * rng.randint(0, 80 * 256, (370, 1224))
            Image.fromarray(depth.astype(np.uint16)).save(os.path.join(d, f"{i:010d}.png"))
    ds, jax_ds = _dataset_pair("KITTIDepthDataset", tree, is_train=True)
    for frame in (1, 2):
        for side in ("l", "r"):
            for flip in (False, True):
                depth = ds.get_depth(tree["scene"], frame, side, flip)
                assert depth.shape == (375, 1242) and depth.dtype == np.float32
                _eq(depth, jax_ds.get_depth(tree["scene"], frame, side, flip))
    for index in range(2):
        for seed in (0, 1, 2):
            _eq(ds.sample(index, np.random.RandomState(seed)),
                jax_ds.sample(index, np.random.RandomState(seed)))


# ------------------------------------------------------------- make3d


def test_make3d_matches_jax(tmp_path):
    rng = np.random.RandomState(10)
    gt, pred = rng.uniform(1, 70, 500), rng.uniform(1, 70, 500)
    _eq(make3d.make3d_errors(gt, pred), jax_make3d.make3d_errors(gt, pred))
    root = make_make3d_tree(str(tmp_path / "make3d"), num_images=2)
    loaded = list(make3d.load_make3d(root))
    assert len(loaded) == 2 and loaded[0][0].shape == (852, 1704, 3)
    assert loaded[0][1].shape == (21, 305)
    _eq(loaded, list(jax_make3d.load_make3d(root)))

    def predict_disp(x):
        """A deterministic stand-in for a network: (1, H, W, 3) -> (1, h, w, 1)."""
        return (0.05 + x[..., :1] * 0.3)[:, ::2, ::2]

    errors = make3d.evaluate_make3d(predict_disp, root)
    _eq(errors, jax_make3d.evaluate_make3d(predict_disp, root))
    assert errors.shape == (4,) and np.isfinite(errors).all()


# ---------------------------------------------------------- stereo frame


STEREO_IDS = (0, -1, 1, "s")


def _stereo_batch(source, tmp_path, monkeypatch):
    """Two samples with frame ids (0, -1, 1, "s") at 64x160: from
    `random_train_inputs`, or from a `KITTIRawDataset` over the synthetic
    tree (its image_03 the left frames' opposite view), a left and a right
    line."""
    from tripled_tpu_torch.utils.inputs import random_train_inputs

    if source == "random_train_inputs":
        return random_train_inputs(2, 64, 160, seed=3, device="cpu", frame_ids=STEREO_IDS)
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")
    tree = make_kitti_tree(str(tmp_path / "kitti"), num_frames=4, height=48, width=160)
    ds = datasets.KITTIRawDataset(data_path=tree["root"], height=64, width=160,
                                  filenames=[f"{tree['scene']} 1 l", f"{tree['scene']} 2 r"],
                                  frame_ids=STEREO_IDS, is_train=True, img_ext=".png")
    rng = np.random.RandomState(0)
    samples = [ds.sample(i, rng) for i in range(2)]
    return {k: torch.from_numpy(np.stack([s[k] for s in samples]))
            for k in ("color", "color_aug", "K", "inv_K", "stereo_T")}


@pytest.mark.parametrize("source", ["random_train_inputs", "kitti_raw_sample"])
def test_stereo_frame_model_forward_and_loss_run(source, tmp_path, monkeypatch):
    """`ModelConfig(frame_ids=(0, -1, 1, "s"))` builds; its model's training
    forward predicts the two temporal poses and warps the stereo view by
    stereo_T (0.015 in x, its sign the side's times the flip's): the loss
    is finite and moves with stereo_T."""
    from tripled_tpu_torch.models.net import TripleDNet

    cfg = ModelConfig(name="mono_baseline", depth_num_layers=18, pose_num_layers=18,
                      frame_ids=STEREO_IDS, height=64, width=160, pose_height=64,
                      pose_width=160, scales=(0,), depth_dropout_rate=0.0,
                      automask=False, disp_norm=False)  # configs/_common.py's stereo values
    batch = _stereo_batch(source, tmp_path, monkeypatch)
    assert batch["color"].shape == (2, 4, 64, 160, 3)
    assert batch["stereo_T"].shape == (2, 4, 4)
    np.testing.assert_array_equal(batch["stereo_T"][:, 0, 3].abs().numpy(), np.float32([0.015] * 2))
    torch.manual_seed(0)
    model = TripleDNet(cfg).train()
    outputs, losses = model(batch)
    assert sorted(outputs["cam_T_cam"]) == [1, 2]
    total = sum(losses.values())
    assert torch.isfinite(total)
    total.backward()
    far = dict(batch, stereo_T=batch["stereo_T"].clone())
    far["stereo_T"][:, 0, 3] *= 20
    with torch.no_grad():
        moved = model(far)[1]["min_reconstruct_loss/0"]
    assert moved.item() != losses["min_reconstruct_loss/0"].item()
