"""KITTI odometry benchmark evaluation (segment errors), the port's copy of
`tripled_tpu/eval/odometry.py`, plain numpy.

The KITTI devkit protocol of the reference's
`mono/tools/kitti_evaluation_toolkit.py:16-650`: per-segment (100–800 m)
translational % and rotational deg/m errors over all starting frames
(every 10th frame), plus scale-aligned ATE and trajectory dumps.

One deliberate difference: the plot suite needs matplotlib. Where it is
installed, `evaluate_odometry` writes the JAX package's plot files; where
it is not, it writes the stats and segment-error files alone. Either way
its result says which, under `plots_written`, when `out_dir` is given.
"""

from __future__ import annotations

import importlib.util
import os
from dataclasses import dataclass

import numpy as np

SEGMENT_LENGTHS = (100, 200, 300, 400, 500, 600, 700, 800)
STEP_SIZE = 10  # evaluate every 10th frame as a segment start


def trajectory_distances(poses: np.ndarray) -> np.ndarray:
    """Cumulative distance along the trajectory."""
    d = [0.0]
    for i in range(1, len(poses)):
        d.append(d[-1] + np.linalg.norm(poses[i][:3, 3] - poses[i - 1][:3, 3]))
    return np.asarray(d)


def _last_frame_from_len(dist: np.ndarray, first: int, length: float) -> int:
    for i in range(first, len(dist)):
        if dist[i] > dist[first] + length:
            return i
    return -1


def rotation_error(T_err: np.ndarray) -> float:
    a, b, c = T_err[0, 0], T_err[1, 1], T_err[2, 2]
    d = 0.5 * (a + b + c - 1.0)
    return float(np.arccos(np.clip(d, -1.0, 1.0)))


def translation_error(T_err: np.ndarray) -> float:
    return float(np.linalg.norm(T_err[:3, 3]))


@dataclass
class SegmentError:
    first_frame: int
    r_err: float  # rad/m
    t_err: float  # fraction of length
    length: float
    speed: float


def calc_sequence_errors(gt: np.ndarray, pred: np.ndarray) -> list[SegmentError]:
    dist = trajectory_distances(gt)
    errors = []
    for first in range(0, len(gt), STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            last = _last_frame_from_len(dist, first, length)
            if last == -1 or last >= len(pred):
                continue
            pose_delta_gt = np.linalg.inv(gt[first]) @ gt[last]
            pose_delta_pred = np.linalg.inv(pred[first]) @ pred[last]
            T_err = np.linalg.inv(pose_delta_pred) @ pose_delta_gt
            r = rotation_error(T_err) / length
            t = translation_error(T_err) / length
            num_frames = last - first + 1
            speed = length / (0.1 * num_frames)
            errors.append(SegmentError(first, r, t, length, speed))
    return errors


def average_segment_errors(errors: list[SegmentError]) -> dict:
    if not errors:
        return {"t_err_percent": float("nan"), "r_err_deg_per_m": float("nan")}
    t = np.mean([e.t_err for e in errors]) * 100.0
    r = np.mean([e.r_err for e in errors]) * 180.0 / np.pi
    return {"t_err_percent": float(t), "r_err_deg_per_m": float(r)}


def per_length_errors(errors: list[SegmentError]) -> dict:
    out = {}
    for length in SEGMENT_LENGTHS:
        sub = [e for e in errors if e.length == length]
        if sub:
            out[length] = average_segment_errors(sub)
    return out


def per_speed_errors(errors: list[SegmentError], bin_size: float = 5.0) -> dict:
    """Speed-binned segment errors (m/s bins), the devkit's speed plot data
    (`mono/tools/kitti_evaluation_toolkit.py` speed-error path)."""
    out = {}
    if not errors:
        return out
    max_speed = max(e.speed for e in errors)
    b = bin_size
    while b <= max_speed + bin_size:
        sub = [e for e in errors if b - bin_size <= e.speed < b]
        if sub:
            out[b] = average_segment_errors(sub)
        b += bin_size
    return out


def scale_optimize(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Optimize a global scale on the translations (monocular ambiguity)."""
    g = gt[:, :3, 3]
    p = pred[:, :3, 3]
    scale = float(np.sum(g * p) / max(np.sum(p**2), 1e-12))
    out = pred.copy()
    out[:, :3, 3] *= scale
    return out


def save_sequence_errors(errors: list[SegmentError], path: str) -> None:
    """Per-segment error dump, devkit format: one line per segment
    `first_frame r_err t_err length speed`
    (`kitti_evaluation_toolkit.py:184-189`)."""
    with open(path, "w") as f:
        for e in errors:
            f.write(f"{e.first_frame} {e.r_err} {e.t_err} {e.length} {e.speed}\n")


def evaluate_odometry(
    gt_poses: np.ndarray,
    pred_poses: np.ndarray,
    align_scale: bool = True,
    out_dir: str | None = None,
    seq_name: str = "seq",
) -> dict:
    n = min(len(gt_poses), len(pred_poses))
    gt, pred = np.asarray(gt_poses)[:n], np.asarray(pred_poses)[:n]
    if align_scale:
        pred = scale_optimize(gt, pred)
    errors = calc_sequence_errors(gt, pred)
    result = average_segment_errors(errors)
    result["per_length"] = per_length_errors(errors)
    result["per_speed"] = per_speed_errors(errors)
    # ATE on positions
    diff = gt[:, :3, 3] - pred[:, :3, 3]
    result["ate_rmse"] = float(np.sqrt((diff**2).sum(-1).mean()))
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{seq_name}_stats.txt"), "w") as f:
            f.write(
                f"t_err {result['t_err_percent']:.4f} %\n"
                f"r_err {result['r_err_deg_per_m']:.6f} deg/m\n"
                f"ate_rmse {result['ate_rmse']:.4f} m\n"
            )
        save_sequence_errors(
            errors, os.path.join(out_dir, f"{seq_name}_seq_errors.txt")
        )
        result["plots_written"] = write_plot_suite(gt, pred, result, out_dir, seq_name)
    return result


# ----------------------------------------------------------------- plot suite
# The full artifact set of the reference devkit eval
# (`kitti_evaluation_toolkit.py:203-553`): xyz / rpy traces, 2D path
# projections, 3D path, per-length and per-speed error curves.


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_dir, name):
    import matplotlib.backends.backend_pdf as backend_pdf

    fig.savefig(
        os.path.join(out_dir, name + ".png"),
        bbox_inches="tight", pad_inches=0.1,
    )
    pdf = backend_pdf.PdfPages(os.path.join(out_dir, name + ".pdf"))
    fig.tight_layout()
    pdf.savefig(fig)
    pdf.close()


def plot_xyz(gt, pred, out_dir, seq_name):
    """x/y/z-vs-frame traces (`kitti_evaluation_toolkit.py:203-241`)."""
    plt = _mpl()
    fig, axarr = plt.subplots(3, sharex="col", figsize=(20, 10))
    labels = ["$x$ (m)", "$y$ (m)", "$z$ (m)"]
    for i in range(3):
        axarr[i].plot(pred[:, i, 3], "-", color="b", label="Ours")
        if gt is not None:
            axarr[i].plot(gt[:, i, 3], "-", color="r", label="GT")
        axarr[i].set_ylabel(labels[i])
        axarr[i].legend(loc="upper right", frameon=True)
    axarr[0].set_title("XYZ")
    axarr[2].set_xlabel("index")
    _save(fig, out_dir, f"{seq_name}_xyz")
    plt.close(fig)


def plot_rpy(gt, pred, out_dir, seq_name):
    """Euler-angle (szxy, like the reference) traces
    (`kitti_evaluation_toolkit.py:243-282`)."""
    from tripled_tpu_torch.tools.transformations import euler_from_matrix_szxy

    plt = _mpl()
    fig, axarr = plt.subplots(3, sharex="col", figsize=(20, 10))
    labels = ["$roll$ (deg)", "$pitch$ (deg)", "$yaw$ (deg)"]

    def angles(poses):
        return np.rad2deg([euler_from_matrix_szxy(p) for p in poses])

    pa = angles(pred)
    ga = angles(gt) if gt is not None else None
    for i in range(3):
        axarr[i].plot(pa[:, i], "-", color="b", label="Ours")
        if ga is not None:
            axarr[i].plot(ga[:, i], "-", color="r", label="GT")
        axarr[i].set_ylabel(labels[i])
        axarr[i].legend(loc="upper right", frameon=True)
    axarr[0].set_title("PRY")
    axarr[2].set_xlabel("index")
    _save(fig, out_dir, f"{seq_name}_rpy")
    plt.close(fig)


def _square_limits(ax):
    xlim, ylim = ax.get_xlim(), ax.get_ylim()
    xm, ym = np.mean(xlim), np.mean(ylim)
    r = max(
        abs(lim - m) for lims, m in ((xlim, xm), (ylim, ym)) for lim in lims
    )
    ax.set_xlim([xm - r, xm + r])
    ax.set_ylim([ym - r, ym + r])


def plot_path_2d(gt, pred, out_dir, seq_name):
    """xz / xy / yz path projections (`kitti_evaluation_toolkit.py:284-364`)."""
    plt = _mpl()
    fig = plt.figure(figsize=(20, 6), dpi=100)
    planes = [(0, 2, "x (m)", "z (m)"), (0, 1, "x (m)", "y (m)"),
              (1, 2, "y (m)", "z (m)")]
    for n, (a, b, xl, yl) in enumerate(planes, start=1):
        ax = fig.add_subplot(1, 3, n)
        if gt is not None:
            ax.plot(gt[:, a, 3], gt[:, b, 3], "r-", label="Ground Truth")
        ax.plot(pred[:, a, 3], pred[:, b, 3], "b-", label="Ours")
        ax.plot(0, 0, "ko", label="Start Point")
        ax.legend(loc="upper right", prop={"size": 10})
        ax.set_xlabel(xl, fontsize=10)
        ax.set_ylabel(yl, fontsize=10)
        _square_limits(ax)
    _save(fig, out_dir, f"{seq_name}_path")
    plt.close(fig)


def plot_path_3d(gt, pred, out_dir, seq_name):
    """3D path (`kitti_evaluation_toolkit.py:366-424`)."""
    plt = _mpl()
    fig = plt.figure(figsize=(8, 8), dpi=110)
    ax = fig.add_subplot(projection="3d")
    ax.plot(pred[:, 0, 3], pred[:, 2, 3], pred[:, 1, 3], "b-", label="Ours")
    if gt is not None:
        ax.plot(gt[:, 0, 3], gt[:, 2, 3], gt[:, 1, 3], "r-",
                label="Ground Truth")
    ax.plot([0], [0], [0], "ko", label="Start Point")
    lims = [ax.get_xlim3d(), ax.get_ylim3d(), ax.get_zlim3d()]
    means = [np.mean(l) for l in lims]
    r = max(abs(lim - m) for ls, m in zip(lims, means) for lim in ls)
    ax.set_xlim3d([means[0] - r, means[0] + r])
    ax.set_ylim3d([means[1] - r, means[1] + r])
    ax.set_zlim3d([means[2] - r, means[2] + r])
    ax.legend()
    ax.set_xlabel("x (m)", fontsize=8)
    ax.set_ylabel("z (m)", fontsize=8)
    ax.set_zlabel("y (m)", fontsize=8)
    ax.view_init(elev=20.0, azim=-35)
    _save(fig, out_dir, f"{seq_name}_path_3D")
    plt.close(fig)


def _plot_error_pair(xs, ts, rs, xlabel, out_dir, name):
    plt = _mpl()
    fig = plt.figure(figsize=(15, 6), dpi=100)
    ax = fig.add_subplot(1, 2, 1)
    ax.plot(xs, ts, "ks-")
    ax.axis([min(xs), max(xs), 0, max(ts) * 1.1 or 1])
    ax.set_xlabel(xlabel, fontsize=15)
    ax.set_ylabel("Translation Error (%)", fontsize=15)
    ax = fig.add_subplot(1, 2, 2)
    ax.plot(xs, rs, "ks-")
    ax.axis([min(xs), max(xs), 0, max(rs) * 1.1 or 1])
    ax.set_xlabel(xlabel, fontsize=15)
    ax.set_ylabel("Rotation Error (deg/m)", fontsize=15)
    fig.savefig(
        os.path.join(out_dir, name + ".png"),
        bbox_inches="tight", pad_inches=0.1,
    )
    plt.close(fig)


def plot_error_segment(per_length: dict, out_dir, seq_name):
    """(`kitti_evaluation_toolkit.py:426-455`)."""
    if not per_length:
        return
    xs = sorted(per_length)
    _plot_error_pair(
        xs,
        [per_length[x]["t_err_percent"] for x in xs],
        [per_length[x]["r_err_deg_per_m"] for x in xs],
        "Path Length (m)", out_dir, f"{seq_name}_error_seg",
    )


def plot_error_speed(per_speed: dict, out_dir, seq_name):
    """x-axis in km/h like the devkit (`kitti_evaluation_toolkit.py:457-486`)."""
    if not per_speed:
        return
    xs = sorted(per_speed)
    _plot_error_pair(
        [x * 3.6 for x in xs],
        [per_speed[x]["t_err_percent"] for x in xs],
        [per_speed[x]["r_err_deg_per_m"] for x in xs],
        "Speed (km/h)", out_dir, f"{seq_name}_error_speed",
    )


def have_matplotlib() -> bool:
    return importlib.util.find_spec("matplotlib") is not None


def write_plot_suite(gt, pred, result, out_dir, seq_name) -> bool:
    """All devkit artifacts; none where matplotlib is not installed.
    Returns whether it wrote them."""
    if not have_matplotlib():
        return False
    plot_xyz(gt, pred, out_dir, seq_name)
    plot_rpy(gt, pred, out_dir, seq_name)
    plot_path_2d(gt, pred, out_dir, seq_name)
    plot_path_3d(gt, pred, out_dir, seq_name)
    plot_error_segment(result.get("per_length", {}), out_dir, seq_name)
    plot_error_speed(result.get("per_speed", {}), out_dir, seq_name)
    return True
