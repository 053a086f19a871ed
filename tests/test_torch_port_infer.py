"""The port's inference CLIs (`tripled_tpu_torch.cli.infer`,
`.infer_singleimage`, `.gather_inference_imgs`) against the JAX package's,
on the CPU.

The model is a small TripleDNet (mono_fm_joint_inpaint_disentangle, R18
everywhere, 64x128), whose prediction runs the depth encoder, the
disentangle split and the CRP decoder. Its JAX variable tree is filled from
a numpy seed and carried into the port with `load_jax_variables`, then
saved as a port checkpoint, which the port's CLIs load through the config
file as a user's run would. The JAX CLIs run their own `main` with their
`load_depth_model` replaced by the same variables and the JAX
`make_predict_fn` (a JAX checkpoint would hold the same tree). Data: a
synthetic KITTI tree (96x320, 6 frames), JAX datasets with
TRIPLED_NATIVE_LOADER=0 (PIL, as the port).

Tolerances:
- `cli.infer`'s depth map against the JAX CLI's: rtol 2e-5, the float32
  step files' loss tolerance (the two networks round float32 sums in
  another order; seen 1.8e-7).
- PNGs: the port's writer gives the JAX writer's pixels bit for bit from
  equal disparities. From the two packages' disparities, a pixel may sit
  one level apart where float32 rounding crosses a quantisation step of
  the colour map (seen: none).
- Input frames written beside the maps are equal bit for bit.
"""

import os
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tripled_tpu.cli import gather_inference_imgs as jax_gather
from tripled_tpu.cli import infer as jax_infer
from tripled_tpu.cli import infer_singleimage as jax_single
from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.config import ExperimentConfig as JaxExperimentConfig
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.models.registry import build_model
from tripled_tpu.train.step import make_predict_fn as jax_make_predict_fn
from tripled_tpu.utils.inputs import dummy_train_inputs
from tripled_tpu_torch.cli import gather_inference_imgs, infer, infer_singleimage
from tripled_tpu_torch.config import load_config
from tripled_tpu_torch.data.synthetic import make_kitti_tree
from tripled_tpu_torch.train import checkpoint as ckpt
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

from test_torch_port_step import _random_variables

torch.set_num_threads(1)

MODEL = dict(name="mono_fm_joint_inpaint_disentangle", depth_num_layers=18, pose_num_layers=18,
             extractor_num_layers=18, height=64, width=128, pose_height=64, pose_width=128,
             auto_res_weight=5e-3, disentangle_layers=(False, False, False, False, True))
CONFIG = """
from tripled_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig

config = ExperimentConfig(model=ModelConfig(**{model!r}), data=DataConfig(**{data!r}),
                          work_dir={work!r})
"""
RTOL = 2e-5


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A tree, the JAX variables, the port's config file and checkpoint."""
    tmp = tmp_path_factory.mktemp("infer")
    tree = make_kitti_tree(str(tmp / "kitti"), num_frames=6, height=96, width=320)
    data = dict(name="kitti", split="synthetic", height=64, width=128, in_path=tree["root"],
                gt_depth_path=tree["gt_depth_path"])
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
    return dict(tmp=tmp, tree=tree, cfg=str(cfg_path), work=str(work), jax_loaded=loaded)


def _run_jax(module, monkeypatch, setup, argv):
    """A JAX CLI's main with the setup's variables in place of its loader."""
    monkeypatch.setattr(jax_infer, "load_depth_model", lambda *a: setup["jax_loaded"])
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["tree"]["splits_dir"])
    module.main()


def _png(path):
    return np.asarray(Image.open(path)).astype(np.int16)


def _hold_disp_png(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def _frame(setup):
    tree = setup["tree"]
    image_dir = os.path.join(tree["root"], tree["scene"], "image_02", "data")
    return os.path.join(image_dir, sorted(os.listdir(image_dir))[0])


def test_infer_matches_jax(setup, monkeypatch):
    image = _frame(setup)
    size = ["--height", "64", "--width", "128"]
    got_dir, want_dir = setup["tmp"] / "infer_port", setup["tmp"] / "infer_jax"
    depth = infer.main(["--config", setup["cfg"], "--checkpoint", setup["work"], "--image", image,
                        "--out_dir", str(got_dir), "--device", "cpu"] + size)
    _run_jax(jax_infer, monkeypatch, setup, ["--config", "x", "--checkpoint", "x", "--image",
                                             image, "--out_dir", str(want_dir)] + size)
    stem = os.path.splitext(os.path.basename(image))[0]
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir)) == [
        f"{stem}_depth.npy", f"{stem}_disp.png"]
    got = np.load(got_dir / f"{stem}_depth.npy")
    want = np.load(want_dir / f"{stem}_depth.npy")
    np.testing.assert_array_equal(depth, got)
    assert got.shape == want.shape == Image.open(image).size[::-1]
    assert np.isfinite(got).all() and got.min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    _hold_disp_png(_png(got_dir / f"{stem}_disp.png"), _png(want_dir / f"{stem}_disp.png"))


def test_disp_png_writers_agree(tmp_path):
    disp = np.random.RandomState(0).rand(24, 40).astype(np.float32) * 0.3
    infer.save_disp_png(disp, tmp_path / "port.png")
    jax_infer._save_disp_png(disp, tmp_path / "jax.png")
    np.testing.assert_array_equal(_png(tmp_path / "port.png"), _png(tmp_path / "jax.png"))


def test_infer_singleimage_matches_jax(setup, monkeypatch):
    got_dir, want_dir = setup["tmp"] / "single_port", setup["tmp"] / "single_jax"
    split = ["--split_file", setup["tree"]["val_split"], "--limit", "3"]
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["tree"]["splits_dir"])
    n = infer_singleimage.main(["--config", setup["cfg"], "--checkpoint", setup["work"],
                                "--out_dir", str(got_dir), "--device", "cpu"] + split)
    _run_jax(jax_single, monkeypatch, setup, ["--config", "x", "--checkpoint", "x",
                                              "--out_dir", str(want_dir)] + split)
    names = sorted(os.listdir(got_dir))
    assert n == 3 and names == sorted(os.listdir(want_dir))
    assert names == sorted(f"{i:05d}_{k}.png" for i in range(3) for k in ("disp", "img"))
    for name in names:
        got, want = _png(got_dir / name), _png(want_dir / name)
        if name.endswith("_img.png"):
            np.testing.assert_array_equal(got, want)
        else:
            _hold_disp_png(got, want)


def test_gather_inference_imgs_matches_jax(setup, monkeypatch):
    got_dir, want_dir = setup["tmp"] / "grid_port", setup["tmp"] / "grid_jax"
    two = ["--configs", setup["cfg"], setup["cfg"], "--checkpoints", setup["work"],
           setup["work"]]
    split = ["--split_file", setup["tree"]["val_split"], "--limit", "2"]
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", setup["tree"]["splits_dir"])
    n = gather_inference_imgs.main(two + ["--out_dir", str(got_dir), "--device", "cpu"] + split)
    _run_jax(jax_gather, monkeypatch, setup, ["--configs", "x", "x", "--checkpoints", "x", "x",
                                              "--out_dir", str(want_dir)] + split)
    names = sorted(os.listdir(got_dir))
    assert n == 2 and names == sorted(os.listdir(want_dir)) == ["00000_grid.png",
                                                                "00001_grid.png"]
    for name in names:
        got, want = _png(got_dir / name), _png(want_dir / name)
        h, w = got.shape[0] // 2, got.shape[1] // 2
        # the frame, the two models' maps, the empty fourth tile
        np.testing.assert_array_equal(got[:h, :w], want[:h, :w])
        _hold_disp_png(got, want)
        np.testing.assert_array_equal(got[h:, :w], got[:h, w:])
        assert not got[h:, w:].any()


@pytest.mark.parametrize("cli", [infer, infer_singleimage, gather_inference_imgs],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_cuda_is_the_default_and_raises_without_a_card(cli, setup):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    argv = {infer: ["--config", setup["cfg"], "--checkpoint", setup["work"], "--image", "x"],
            infer_singleimage: ["--config", setup["cfg"], "--checkpoint", setup["work"]],
            gather_inference_imgs: ["--configs", setup["cfg"], "--checkpoints",
                                    setup["work"]]}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--out_dir", str(setup["tmp"] / "never")])
