"""The port's odometry and Make3D entry points against the JAX package's, on
the CPU: `TripleDNet.predict_pose`, the CLIs `eval_pose`, `draw_odometry`,
`eval_make3d` and `gen_split` against the JAX CLIs' `main`, and the two
synthetic trees they read (`make_kitti_odom_tree`, `make_make3d_tree`).
About 45 s on one CPU worker (pytest's seconds).

The model is a small mono_baseline (R18 depth and pose nets, 64x128). Its
JAX variable tree is filled from a numpy seed and carried into the port
with `load_jax_variables`, then saved as a port checkpoint, which the
port's CLIs load through the config file as a user's run would. The JAX
CLIs run their own `main` with their `load_depth_model` replaced by the
same variables (a JAX checkpoint would hold the same tree). Data: an
odometry tree of 12 frames at 96x320 (11 pairs: a full batch of 8 and a
padded one of 3), read at 64x128 as the config says; a Make3D tree of two
images at Make3D's 1704x2272; JAX datasets with TRIPLED_NATIVE_LOADER=0
(PIL, as the port's).

Tolerances:
- `predict_pose` in float64 against the JAX method with train=False:
  1e-9 of the outputs' largest magnitude (seen 2e-16).
- The CLIs' transforms, poses and errors in float32: rtol 2e-5, the
  float32 step files' loss tolerance (the two networks round float32 sums
  in another order), with atol 1e-7 on the transforms' elements, whose
  rotations sit at 1 and 0 (seen: transforms 6e-9, Make3D errors 3e-7
  relative). The ATE's std is held within 2e-5 of the ATE's mean: a
  random network's ATE barely varies along the sequence, so its std
  (1.3e-4 of the mean) carries the transforms' float32 rounding
  relatively larger (seen 2.9e-9 absolute, 6.2e-5 of itself).
- Files: the segment errors and the split files equal byte for byte; the
  predicted pose files equal as numbers within the tolerance above (their
  text holds 7 digits of float32 values); the same plot files written.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

from tripled_tpu.cli import draw_odometry as jax_draw_odometry
from tripled_tpu.cli import eval_make3d as jax_eval_make3d
from tripled_tpu.cli import eval_pose as jax_eval_pose
from tripled_tpu.cli import gen_split as jax_gen_split
from tripled_tpu.cli import infer as jax_infer
from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.config import ExperimentConfig as JaxExperimentConfig
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.eval import make3d as jax_make3d
from tripled_tpu.eval.pose import evaluate_pose_ate
from tripled_tpu.models.net import TripleDNet as JaxTripleDNet
from tripled_tpu.models.registry import build_model
from tripled_tpu.train.step import make_predict_fn as jax_make_predict_fn
from tripled_tpu.utils.inputs import dummy_train_inputs
from tripled_tpu_torch.cli import draw_odometry, eval_make3d, eval_pose, gen_split
from tripled_tpu_torch.config import ModelConfig, OptimConfig, load_config
from tripled_tpu_torch.data.synthetic import (
    _PARALLAX_STEP,
    make_kitti_odom_tree,
    make_kitti_tree,
    make_make3d_tree,
)
from tripled_tpu_torch.eval.pose import load_kitti_poses
from tripled_tpu_torch.train import checkpoint as ckpt
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

from test_torch_port_step import _random_variables

torch.set_num_threads(1)

MODEL = dict(name="mono_baseline", depth_num_layers=18, pose_num_layers=18, height=64,
             width=128, pose_height=64, pose_width=128)
CONFIG = """
from tripled_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig

config = ExperimentConfig(model=ModelConfig(**{model!r}), data=DataConfig(**{data!r}),
                          work_dir={work!r})
"""
RTOL, ATOL_T = 2e-5, 1e-7


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The trees, the JAX variables, the port's config file and checkpoint."""
    tmp = tmp_path_factory.mktemp("eval_clis")
    odom = make_kitti_odom_tree(str(tmp / "odom"), num_frames=12, height=96, width=320)
    data = dict(name="kitti_odom", split="synthetic", height=64, width=128, png=True,
                in_path=odom["root"])
    jmodel = build_model(JaxModelConfig(**MODEL))
    params, stats = _random_variables(jmodel, dummy_train_inputs(JaxModelConfig(**MODEL), 1))
    work = tmp / "work"
    cfg_path = tmp / "cfg.py"
    cfg_path.write_text(CONFIG.format(model=MODEL, data=data, work=str(work)))
    cfg = load_config(str(cfg_path))
    state = create_train_state(cfg.model, cfg.optim, steps_per_epoch=1, device="cpu")
    load_jax_variables(state.model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    ckpt.save_checkpoint(str(work), state, 1)
    jax_cfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL), data=JaxDataConfig(**data))
    loaded = (jax_cfg, types.SimpleNamespace(variables={"params": params, "batch_stats": stats}),
              jax_make_predict_fn(jmodel))
    return dict(tmp=tmp, odom=odom, cfg=str(cfg_path), work=str(work), jax_loaded=loaded,
                jmodel=jmodel, params=params, stats=stats,
                make3d=make_make3d_tree(str(tmp / "make3d"), num_images=2))


def _run_jax(module, monkeypatch, setup, argv):
    """A JAX CLI's main with the setup's variables in place of its loader."""
    monkeypatch.setattr(jax_infer, "load_depth_model", lambda *a: setup["jax_loaded"])
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def _odom_args(setup):
    return ["--config", setup["cfg"], "--checkpoint", setup["work"], "--sequence", "09",
            "--gt_poses_dir", setup["odom"]["gt_poses_dir"]]


def _record_jax_transforms(monkeypatch):
    """Keep what the JAX CLI's predict_sequence_transforms returns."""
    seen = []
    inner = jax_eval_pose.predict_sequence_transforms

    def wrapped(*a, **k):
        seen.append(inner(*a, **k))
        return seen[-1]

    monkeypatch.setattr(jax_eval_pose, "predict_sequence_transforms", wrapped)
    return seen


def test_predict_pose_float64_matches_jax(setup):
    """Eval mode, BatchNorm on its running statistics, in float64; the
    modules' modes and statistics as they were."""
    to64 = lambda tree: jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)
    params, stats = to64(setup["params"]), to64(setup["stats"])
    pair = np.random.RandomState(0).rand(3, 64, 128, 6)
    with jax.enable_x64(True):
        want = jax.jit(lambda v, x: setup["jmodel"].apply(
            v, x, train=False, method=JaxTripleDNet.predict_pose))(
            {"params": params, "batch_stats": stats}, pair)
        want = [np.asarray(w) for w in want]
    model = create_train_state(ModelConfig(**MODEL), OptimConfig(), 1,
                               device="cpu").model.to(torch.float64)
    load_jax_variables(model, params, stats)
    model.train()
    next(model.pose_encoder.children()).eval()  # a mixed state, kept as it is
    modes = [m.training for m in model.modules()]
    buffers = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        got = model.predict_pose(torch.from_numpy(pair))
    assert [m.training for m in model.modules()] == modes
    for k, v in model.named_buffers():
        assert torch.equal(v, buffers[k]), k
    for g, w in zip(got, want):
        assert g.shape == w.shape == (3, 1, 1, 3) and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9 * np.abs(w).max())


def test_eval_pose_matches_jax(setup, monkeypatch, capsys):
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["odom"]["splits_dir"])
    got = eval_pose.main(_odom_args(setup) + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    seen = _record_jax_transforms(monkeypatch)
    _run_jax(jax_eval_pose, monkeypatch, setup, _odom_args(setup))
    jax_out = capsys.readouterr().out
    (want,) = seen
    assert got["transforms"].shape == want.shape == (11, 4, 4) and got["pairs"] == 11
    np.testing.assert_allclose(got["transforms"], want, rtol=RTOL, atol=ATOL_T)
    gt = load_kitti_poses(os.path.join(setup["odom"]["gt_poses_dir"], "09.txt"))
    mean, std = evaluate_pose_ate(want, gt)
    np.testing.assert_allclose(got["ate_mean"], mean, rtol=RTOL)
    np.testing.assert_allclose(got["ate_std"], std, rtol=0, atol=RTOL * mean)
    assert port_out == jax_out and port_out.startswith("seq 09: ATE ")


def test_draw_odometry_matches_jax(setup, monkeypatch, capsys):
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["odom"]["splits_dir"])
    port_dir, jax_dir = setup["tmp"] / "draw_port", setup["tmp"] / "draw_jax"
    got = draw_odometry.main(_odom_args(setup) + ["--out_dir", str(port_dir), "--device", "cpu"])
    port_out = capsys.readouterr().out
    _run_jax(jax_draw_odometry, monkeypatch, setup, _odom_args(setup) + ["--out_dir", str(jax_dir)])
    jax_out = capsys.readouterr().out
    assert got.pop("plots_written") is True  # matplotlib is installed here
    assert sorted(os.listdir(port_dir)) == sorted(os.listdir(jax_dir))
    assert "09_pred.txt" in os.listdir(port_dir) and "09_path.png" in os.listdir(port_dir)
    pred = load_kitti_poses(str(port_dir / "09_pred.txt"))
    want = load_kitti_poses(str(jax_dir / "09_pred.txt"))
    assert pred.shape == (12, 4, 4)
    np.testing.assert_allclose(pred, want, rtol=RTOL, atol=ATOL_T)
    np.testing.assert_allclose(got["global_poses"], want, rtol=RTOL, atol=ATOL_T)
    assert (port_dir / "09_seq_errors.txt").read_bytes() == (
        jax_dir / "09_seq_errors.txt").read_bytes()
    # 12 frames are too short for a 100 m segment: nan, as in the JAX CLI
    assert np.isnan(got["t_err_percent"]) and np.isfinite(got["ate_rmse"])
    assert port_out == jax_out


def test_draw_odometry_without_matplotlib(setup, monkeypatch, capsys):
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["odom"]["splits_dir"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out_dir = setup["tmp"] / "draw_no_plots"
    got = draw_odometry.main(_odom_args(setup) + ["--out_dir", str(out_dir), "--device", "cpu"])
    assert got["plots_written"] is False
    assert sorted(os.listdir(out_dir)) == ["09_pred.txt", "09_seq_errors.txt", "09_stats.txt"]
    assert "plots not written: matplotlib is not installed" in capsys.readouterr().out


def test_eval_make3d_matches_jax(setup, monkeypatch, capsys):
    args = ["--config", setup["cfg"], "--checkpoint", setup["work"], "--make3d_path",
            setup["make3d"]]
    errors = eval_make3d.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    # the JAX CLI imports evaluate_make3d in its main: keep what it returns
    seen = []
    real = jax_make3d.evaluate_make3d
    monkeypatch.setattr(jax_make3d, "evaluate_make3d",
                        lambda *a, **k: seen.append(real(*a, **k)) or seen[-1])
    _run_jax(jax_eval_make3d, monkeypatch, setup, args)
    jax_out = capsys.readouterr().out
    (want,) = seen
    assert errors.shape == (4,) and np.isfinite(errors).all()
    np.testing.assert_allclose(errors, want, rtol=RTOL)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]


@pytest.mark.parametrize("module", [eval_pose, draw_odometry, eval_make3d])
def test_clis_refuse_the_cpu_by_default(setup, module):
    """`--device cuda` is the default; without a card the CLI raises and
    never goes on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is there")
    extra = {eval_make3d: ["--make3d_path", setup["make3d"]]}.get(
        module, ["--gt_poses_dir", setup["odom"]["gt_poses_dir"]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--config", setup["cfg"], "--checkpoint", setup["work"]] + extra)


def test_gen_split_matches_jax(tmp_path, monkeypatch):
    root = tmp_path / "raw"
    for date, drive, n in (("2011_09_26", "2011_09_26_drive_0001_sync", 7),
                           ("2011_09_26", "2011_09_26_drive_0002_sync", 5),
                           ("2011_09_28", "2011_09_28_drive_0001_sync", 6)):
        make_kitti_tree(str(root), num_frames=n, height=8, width=16, date=date, drive=drive)
    for argv in (["--val_frac", "0.3"], ["--side", "r", "--seed", "7", "--val_frac", "0.25"]):
        train, val = gen_split.main(["--data_path", str(root), "--out_dir",
                                     str(tmp_path / "port")] + argv)
        monkeypatch.setattr(sys, "argv", ["gen_split", "--data_path", str(root), "--out_dir",
                                          str(tmp_path / "jax")] + argv)
        jax_gen_split.main()
        for name in ("train_files.txt", "val_files.txt"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        assert len(train) + len(val) == 5 + 3 + 4 and val


def test_odometry_tree(tmp_path):
    """Ground truth at the parallax camera's positions; frames at the asked
    size, rendered small and resized with render_scale."""
    from PIL import Image

    for scale in (1, 4):
        tree = make_kitti_odom_tree(str(tmp_path / f"s{scale}"), sequence="10", num_frames=4,
                                    height=64, width=160, render_scale=scale)
        poses = load_kitti_poses(os.path.join(tree["gt_poses_dir"], "10.txt"))
        want = np.tile(np.eye(4), (4, 1, 1))
        want[:, :3, 3] = np.arange(4)[:, None] * _PARALLAX_STEP
        np.testing.assert_allclose(poses, want, rtol=1e-6, atol=0)
        frames = sorted(os.listdir(os.path.join(tree["root"], "sequences", "10", "image_0")))
        assert frames == [f"{i:06d}.png" for i in range(4)]
        img = Image.open(os.path.join(tree["root"], "sequences", "10", "image_0", frames[0]))
        assert img.size == (160, 64)
        with open(os.path.join(tree["splits_dir"], "odom", "test_files_10.txt")) as f:
            assert f.read() == "10 0 l\n10 1 l\n10 2 l\n"
