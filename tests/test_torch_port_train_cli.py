"""The port's train and eval CLIs end to end on the CPU
(`python -m tripled_tpu_torch.cli.train ... --device cpu`), on a synthetic
KITTI tree (96x320, 6 frames: 4 train and 4 val lines), for a small
mono_fm and a small mono_fm_joint_inpaint_disentangle (R18 everywhere,
64x128, pose net at 64x128, batch 2, so 2 steps an epoch):

- run 1 (1 epoch): finite losses in metrics.jsonl under the keys the step
  returns, `ckpt/epoch_1.pt` and `latest`, the eval hook's metrics;
- a restore into a fresh state gives every parameter, BatchNorm buffer,
  Adam moment and the update count back bit for bit;
- run 2 (`--auto_resume`, 2 epochs) starts at epoch 1 with the count at 2
  and ends at 4;
- `cli.eval_depth` on `ckpt/epoch_2` gives the hook's epoch-2 metrics
  exactly (the same weights, batches and arithmetic).
"""

import json
import os

import numpy as np
import pytest
import torch

from tripled_tpu_torch.cli import eval_depth, train
from tripled_tpu_torch.config import load_config
from tripled_tpu_torch.data.synthetic import make_kitti_tree
from tripled_tpu_torch.eval.depth_metrics import METRIC_NAMES
from tripled_tpu_torch.train import checkpoint as ckpt
from tripled_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

SMALL = dict(depth_num_layers=18, pose_num_layers=18, extractor_num_layers=18, height=64,
             width=128, pose_height=64, pose_width=128)
PRESETS = {
    "mono_fm": (dict(name="mono_fm", **SMALL), dict(name="kitti")),
    "flagship": (dict(name="mono_fm_joint_inpaint_disentangle", auto_res_weight=5e-3,
                      disentangle_layers=(False, False, False, False, True), **SMALL),
                 dict(name="kitti_inpaint", erase_count=4, erase_shape=(8, 8))),
}
SCALES = range(4)
LOSS_KEYS = {
    "mono_fm": ["min_perceptional_loss"]
    + [f"{k}/{s}" for s in SCALES for k in ("min_reconstruct_loss", "smooth_loss")],
    "flagship": [f"feature_regularization_loss/{i}" for i in range(5)]
    + ["min_perceptional_loss"]
    + [f"{k}/{s}" for s in SCALES
       for k in ("img_reconstruct_loss", "min_reconstruct_loss", "smooth_loss")]
    + ["auto_res_loss"],
}
CONFIG = """
from tripled_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, OptimConfig

config = ExperimentConfig(
    model=ModelConfig(**{model!r}),
    data=DataConfig(split="synthetic", height=64, width=128, in_path={root!r},
                    gt_depth_path={gt!r}, batch_size=2, **{data!r}),
    optim=OptimConfig(total_epochs={epochs}, warmup_iters=2),
    work_dir={work!r}, log_interval=1, seed=3)
"""


def _write_config(path, preset, tree, work, epochs):
    model, data = PRESETS[preset]
    path.write_text(CONFIG.format(model=model, data=data, root=tree["root"],
                                  gt=tree["gt_depth_path"], work=str(work), epochs=epochs))
    return str(path)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=6, height=96,
                           width=320)


@pytest.fixture(scope="module", params=list(PRESETS))
def runs(request, tree, tmp_path_factory):
    """Run 1, a restore of its checkpoint, run 2 and the eval CLI."""
    preset = request.param
    tmp = tmp_path_factory.mktemp(preset)
    work = tmp / "work"
    cfg1 = _write_config(tmp / "cfg1.py", preset, tree, work, epochs=1)
    cfg2 = _write_config(tmp / "cfg2.py", preset, tree, work, epochs=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRIPLED_SPLITS_DIR", tree["splits_dir"])
        state1, hist1 = train.main(["--config", cfg1, "--device", "cpu"])
        files1 = sorted(os.listdir(work / "ckpt"))
        restored = create_train_state(load_config(cfg1).model, load_config(cfg1).optim,
                                      steps_per_epoch=2, seed=99, device="cpu")
        restored, epoch = ckpt.restore_checkpoint(str(work), restored)
        state2, hist2 = train.main(["--config", cfg2, "--device", "cpu", "--auto_resume"])
        metrics = eval_depth.main(["--config", cfg2, "--checkpoint",
                                   str(work / "ckpt" / "epoch_2"), "--device", "cpu"])
    rows = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    return dict(preset=preset, work=work, state1=state1, hist1=hist1, files1=files1,
                restored=restored, restored_epoch=epoch, state2=state2, hist2=hist2,
                eval=metrics, rows=rows)


def test_losses_are_logged_and_finite(runs):
    train_rows = [r for r in runs["rows"] if "train/loss" in r]
    assert [r["step"] for r in train_rows] == [1, 2, 3, 4]
    want = {f"train/{k}" for k in LOSS_KEYS[runs["preset"]] + ["loss", "grad_norm", "lr"]}
    for r in train_rows:
        assert set(r) - {"step", "time"} == want
        assert all(np.isfinite(v) for v in r.values())
    epoch_rows = [r for r in runs["rows"] if "epoch/loader_wait_s" in r]
    assert [(r["step"], r["epoch/steps"]) for r in epoch_rows] == [(2, 2.0), (4, 2.0)]


def test_checkpoint_written(runs):
    assert runs["files1"] == ["epoch_1.pt", "latest"]
    assert (runs["work"] / "ckpt" / "latest").read_text() == "epoch_2.pt"
    assert (runs["work"] / "ckpt" / "epoch_2.pt").exists()
    assert (runs["work"] / "config_dump.py").exists()


def test_restore_is_bit_equal(runs):
    saved, restored = runs["state1"], runs["restored"]
    assert runs["restored_epoch"] == 1
    want, got = saved.model.state_dict(), restored.model.state_dict()
    assert list(want) == list(got)
    assert any("running_mean" in k for k in want)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert saved.optimizer.count == restored.optimizer.count == 2
    for key in ("mu", "nu"):
        a, b = getattr(saved.optimizer, key), getattr(restored.optimizer, key)
        assert set(a) == set(b)
        for kind in a:
            assert all(torch.equal(x, y) for x, y in zip(a[kind], b[kind])), (key, kind)
            assert any(x.abs().sum() > 0 for x in a[kind])


def test_auto_resume_carries_the_count(runs):
    assert runs["state2"].optimizer.count == 4
    assert [h["epoch"] for h in runs["hist1"]] == [1]
    assert [h["epoch"] for h in runs["hist2"]] == [2]  # run 2 trained epoch 1 (0-based) only
    # run 2 moved the weights on from the checkpoint it resumed
    moved = [not torch.equal(a, b) for a, b in zip(runs["state1"].model.parameters(),
                                                  runs["state2"].model.parameters())]
    assert any(moved)


def test_eval_cli_reproduces_the_hook(runs):
    hook = runs["hist2"][-1]
    val_rows = [r for r in runs["rows"] if "val/abs_rel" in r]
    assert [r["step"] for r in val_rows] == [2, 4]
    for k in METRIC_NAMES + ("scale_ratio_med", "scale_ratio_std"):
        assert runs["eval"][k] == hook[k] == val_rows[-1][f"val/{k}"], k
        assert np.isfinite(hook[k])


def test_load_weights_keeps_a_fresh_optimizer(runs):
    cfg = runs["state1"].model.cfg
    from tripled_tpu_torch.config import OptimConfig

    fresh = create_train_state(cfg, OptimConfig(), steps_per_epoch=2, seed=99, device="cpu")
    fresh = ckpt.load_weights(str(runs["work"] / "ckpt" / "epoch_1.pt"), fresh)
    for k, v in runs["state1"].model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.optimizer.count == 0
    assert all(float(m.abs().sum()) == 0 for ms in fresh.optimizer.mu.values() for m in ms)


def test_device_cuda_without_a_card_raises(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CLI would run on it")
    cfg = _write_config(tmp_path / "cfg.py", "mono_fm", tree, tmp_path / "work", epochs=1)
    for main, extra in [(train.main, []), (eval_depth.main, ["--checkpoint", str(tmp_path)])]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--config", cfg, "--device", "cuda", *extra])
    assert not (tmp_path / "work").exists()


def test_metric_logger_rows_match_jax(tmp_path):
    from tripled_tpu.utils.logging import MetricLogger as JaxMetricLogger
    from tripled_tpu.utils.logging import StepTimer as JaxStepTimer
    from tripled_tpu_torch.utils.logging import MetricLogger, StepTimer

    metrics = {"loss": torch.tensor(0.25), "lr": 1e-4, "note": "text", "n": np.int64(3)}
    for cls, name in [(JaxMetricLogger, "jax"), (MetricLogger, "port")]:
        logger = cls(str(tmp_path / name))
        logger.log(7, metrics, prefix="train/")
        logger.close()
    rows = {name: json.loads((tmp_path / name / "metrics.jsonl").read_text())
            for name in ("jax", "port")}
    for row in rows.values():
        row.pop("time")
    assert rows["port"] == rows["jax"] == {"step": 7, "train/loss": 0.25, "train/lr": 1e-4,
                                           "train/n": 3.0}
    timers = [JaxStepTimer(warmup=1), StepTimer(warmup=1)]
    for timer in timers:
        for _ in range(4):
            timer.tick(12)
    assert [(t.count, t.imgs) for t in timers] == [(3, 36), (3, 36)]
    assert all(t.imgs_per_sec > 0 for t in timers)
