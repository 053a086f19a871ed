"""The port's segmentation CLIs end to end on the CPU
(`python -m tripled_tpu_torch.cli.train_segmentation ... --device cpu`), on
small synthetic KITTI semseg trees (10 frames: 8 train, 2 test), R18
encoders at 64x96, batch 2, 2 steps:

- for each of the three models: `ckpt/epoch_1.pt`, finite `train/seg_ce_loss`
  rows and the `val/miou` and `val/acc` rows in metrics.jsonl; then
  `cli.eval_segmentation` on the epoch-1 checkpoint prints and returns
  exactly the hook's mIoU and accuracy;
- `--depth_checkpoint` on a checkpoint of the config's own depth model
  (`train/checkpoint.save_checkpoint`; mono_baseline here, whose depth
  encoder is the one every preset has): the encoder starts as the depth
  encoder, parameters and BatchNorm statistics; under FixSegmentationDepth
  its parameters are unchanged after the steps and its statistics moved.
  BaseSegmentationFeat takes the depth encoder into its extractor where the
  two are the same ResNet, as the JAX CLI's transplant does, and raises a
  ValueError where they differ (the JAX CLI fails with flax's
  ScopeParamShapeError there);
- the images larger than the config (96x144 against 64x96; the labels keep
  their size): the JAX CLI's eval hook raises an IndexError, while the
  port's hook scores at the label's size, equal to a reference built from
  the JAX package's own `resize_bilinear` and `SegmentationRunningScore` on
  the port model's log-probabilities.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tripled_tpu.cli import train_segmentation as jax_train_segmentation
from tripled_tpu.eval.segmentation_metrics import SegmentationRunningScore as JaxScore
from tripled_tpu.ops.image import resize_bilinear as jax_resize_bilinear
from tripled_tpu_torch.cli import eval_segmentation, train_segmentation
from tripled_tpu_torch.config import load_config
from tripled_tpu_torch.data.seg_datasets import get_test_segmentation_dataset
from tripled_tpu_torch.data.synthetic import make_kitti_seg_tree
from tripled_tpu_torch.models.segmentation import SEGMENTATION
from tripled_tpu_torch.train import checkpoint as ckpt
from tripled_tpu_torch.train import step as step_module
from tripled_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

CONFIG = """
from tripled_tpu{pkg}.config import DataConfig, ExperimentConfig, ModelConfig, OptimConfig

config = ExperimentConfig(
    model=ModelConfig(name={model!r}, depth_num_layers=18, pose_num_layers=18,
                      extractor_num_layers={extractor}, height=64, width=96),
    data=DataConfig(name="kitti", in_path={root!r}, height=64, width=96, batch_size=2),
    optim=OptimConfig(total_epochs=1, warmup_iters=1),
    work_dir={work!r}, log_interval=1)
"""


def write_config(tmp_path, root, label, extractor=18, pkg="_torch",
                 model="mono_fm_joint_inpaint"):
    """A config file; `model` names the depth model, which only
    `--depth_checkpoint` builds (mono_baseline, without an extractor, builds
    quicker)."""
    work = str(tmp_path / f"work_{label}")
    path = tmp_path / f"cfg_{label}.py"
    path.write_text(CONFIG.format(pkg=pkg, model=model, extractor=extractor, root=root,
                                  work=work))
    return str(path), work


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_seg_tree(str(tmp_path_factory.mktemp("kitti_seg")))


def _rows(work):
    with open(os.path.join(work, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", list(SEGMENTATION))
def test_train_then_eval_cli(name, tree, tmp_path, capsys):
    config, work = write_config(tmp_path, tree, name)
    state, history = train_segmentation.main(
        ["--config", config, "--model", name, "--max_steps_per_epoch", "2", "--device", "cpu"])
    assert state.optimizer.count == 2
    assert os.path.exists(os.path.join(work, "ckpt", "epoch_1.pt"))
    rows = _rows(work)
    losses = [r["train/seg_ce_loss"] for r in rows if "train/seg_ce_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    (val,) = [r for r in rows if "val/miou" in r]
    assert [h["epoch"] for h in history] == [1]
    assert val["val/miou"] == history[0]["meaniou"] and val["val/acc"] == history[0]["meanacc"]
    assert 0 < history[0]["meaniou"] < 1

    capsys.readouterr()
    m = eval_segmentation.main(["--config", config, "--checkpoint",
                                os.path.join(work, "ckpt", "epoch_1"), "--model", name,
                                "--device", "cpu"])
    assert m["meaniou"] == history[0]["meaniou"] and m["meanacc"] == history[0]["meanacc"]
    np.testing.assert_array_equal(m["acc"], history[0]["acc"])
    out = capsys.readouterr().out
    assert f" miou: {history[0]['meaniou']:8.3f} | acc: {history[0]['meanacc']:8.3f}" in out


def _depth_checkpoint(config, tmp_path):
    cfg = load_config(config)
    depth = create_train_state(cfg.model, cfg.optim, steps_per_epoch=1, seed=5, device="cpu")
    # BatchNorm statistics that differ from a fresh model's
    with torch.no_grad():
        for name, buf in depth.model.named_buffers():
            if "running" in name:
                buf.add_(torch.rand_like(buf) * 0.1)
    path = ckpt.save_checkpoint(str(tmp_path / "depth"), depth, 3)
    return path, depth.model.depth_encoder.state_dict()


@pytest.mark.parametrize("name", ["FixSegmentationDepth", "BaseSegmentationFeat"])
def test_depth_checkpoint(name, tree, tmp_path, monkeypatch):
    config, work = write_config(tmp_path, tree, name, model="mono_baseline")
    path, encoder = _depth_checkpoint(config, tmp_path)
    # the encoder at step 0, as the CLI hands its model to the train step
    start = {}
    make_step = step_module.make_segmentation_train_step

    def recording(model, optimizer):
        start.update({k: v.clone() for k, v in model.encoder.state_dict().items()})
        return make_step(model, optimizer)

    monkeypatch.setattr(step_module, "make_segmentation_train_step", recording)
    state, _ = train_segmentation.main(
        ["--config", config, "--model", name, "--depth_checkpoint", path,
         "--max_steps_per_epoch", "2", "--device", "cpu"])
    assert start.keys() == encoder.keys()
    for k, v in encoder.items():
        assert torch.equal(start[k], v), k
    after = state.model.encoder.state_dict()
    params = {n for n, _ in state.model.encoder.named_parameters()}
    stats = [k for k in after if "running" in k]
    assert stats and all(not torch.equal(after[k], encoder[k]) for k in stats)
    same = [torch.equal(after[k], encoder[k]) for k in params]
    if name == "FixSegmentationDepth":
        assert all(same)  # frozen, and weight decay 0
    else:
        assert not any(same)


def test_feat_depth_checkpoint_needs_the_same_resnet(tree, tmp_path):
    config, _ = write_config(tmp_path, tree, "feat34", extractor=34, model="mono_baseline")
    path, _ = _depth_checkpoint(config, tmp_path)
    with pytest.raises(ValueError, match="not the same network"):
        train_segmentation.main(["--config", config, "--model", "BaseSegmentationFeat",
                                 "--depth_checkpoint", path, "--device", "cpu"])


def test_eval_at_the_labels_size(tmp_path, monkeypatch):
    """Images and labels at 96x144, the config at 64x96."""
    root = make_kitti_seg_tree(str(tmp_path / "large"), height=96, width=144)
    jax_config, _ = write_config(tmp_path, root, "jax", pkg="")
    monkeypatch.setattr(sys, "argv", ["train_segmentation", "--config", jax_config,
                                      "--model", "BaseSegmentationDepth",
                                      "--max_steps_per_epoch", "1"])
    with pytest.raises(IndexError, match="boolean index did not match"):
        jax_train_segmentation.main()

    config, work = write_config(tmp_path, root, "port")
    state, history = train_segmentation.main(
        ["--config", config, "--model", "BaseSegmentationDepth", "--max_steps_per_epoch", "1",
         "--device", "cpu"])
    model = state.model.eval()
    dataset = get_test_segmentation_dataset(load_config(config).data, val=False)
    ref = JaxScore(20)
    for i in range(len(dataset)):
        s = dataset.sample(i, np.random.RandomState(0))
        assert s["image"].shape == (64, 96, 3) and s["label"].shape == (96, 144)
        with torch.no_grad():
            log_probs = model({"image": torch.from_numpy(s["image"][None])}).numpy()
        up = np.asarray(jax_resize_bilinear(jnp.asarray(log_probs), 96, 144))
        ref.update(s["label"][None], up.argmax(-1))
    assert ref.confusion_matrix.sum() == len(dataset) * 96 * 144
    for k in ("meaniou", "meanacc", "totalacc", "freqwacc"):
        assert history[0][k] == ref.get_scores()[k], k
    (val,) = [r for r in _rows(work) if "val/miou" in r]
    assert val["val/miou"] == ref.get_scores()["meaniou"]
