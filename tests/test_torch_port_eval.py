"""The port's Eigen depth evaluation against the JAX package's.

- `compute_errors`, `per_image_depth_metrics` and
  `batch_post_process_disparity` (copies, numpy and PIL only): equal bit
  for bit on seeded arrays.
- `DepthEvaluator`: a small mono_baseline (R18, 64x128) with the same
  weights in both packages (the JAX variable tree filled from a numpy seed
  and carried over with `load_jax_variables`), each package's evaluator on
  its own dataset of a `scene="parallax"` synthetic tree, with and without
  flip post-processing. The 7 metrics and the median scale ratio agree to
  1e-5 relative (seen 4e-8): the two networks' disparities differ by
  float32 rounding of another summation order, which moves the per-image
  medians and means by about as much.

JAX datasets are built with TRIPLED_NATIVE_LOADER=0 (PIL, as the port).
"""

import jax
import numpy as np
import pytest
import torch

from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.data.get_dataset import get_dataset as jax_get_dataset
from tripled_tpu.eval import depth_metrics as jax_metrics
from tripled_tpu.eval.evaluator import DepthEvaluator as JaxDepthEvaluator
from tripled_tpu.models.registry import build_model
from tripled_tpu.train.step import make_predict_fn as jax_make_predict_fn
from tripled_tpu.utils.inputs import dummy_train_inputs
from tripled_tpu_torch.config import DataConfig, ModelConfig
from tripled_tpu_torch.data.get_dataset import get_dataset
from tripled_tpu_torch.data.synthetic import make_kitti_tree
from tripled_tpu_torch.eval import depth_metrics
from tripled_tpu_torch.eval.evaluator import DepthEvaluator
from tripled_tpu_torch.models.net import TripleDNet
from tripled_tpu_torch.train.step import make_predict_fn
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

from test_torch_port_step import _random_variables, kernels_not_drawn

torch.set_num_threads(1)

RTOL = 1e-5
MODEL = dict(name="mono_baseline", depth_num_layers=18, pose_num_layers=18, height=64,
             width=128, pose_height=64, pose_width=128, depth_dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")


def test_compute_errors_matches_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(1, 80, 5000)
    pred = gt * rng.uniform(0.7, 1.4, 5000)
    assert depth_metrics.compute_errors(gt, pred) == jax_metrics.compute_errors(gt, pred)
    assert depth_metrics.METRIC_NAMES == jax_metrics.METRIC_NAMES


@pytest.mark.parametrize("stereo_scale", [False, True])
def test_per_image_depth_metrics_matches_jax(stereo_scale):
    rng = np.random.RandomState(1)
    gt = rng.uniform(0, 90, (75, 250)).astype(np.float32)
    gt[rng.rand(75, 250) < 0.6] = 0  # sparse, as lidar ground truth is
    disp = rng.uniform(0.01, 0.3, (32, 104)).astype(np.float32)
    a = depth_metrics.per_image_depth_metrics(disp, gt, stereo_scale=stereo_scale)
    b = jax_metrics.per_image_depth_metrics(disp, gt, stereo_scale=stereo_scale)
    np.testing.assert_array_equal(a, b)
    assert depth_metrics.per_image_depth_metrics(disp, np.zeros_like(gt)) is None
    rows = np.stack([a, a * 1.1])
    for x, y in zip(depth_metrics.aggregate_depth_metric_rows(rows),
                    jax_metrics.aggregate_depth_metric_rows(rows)):
        np.testing.assert_array_equal(x, y)


def test_batch_post_process_disparity_matches_jax():
    rng = np.random.RandomState(2)
    l_disp, r_disp = rng.rand(2, 3, 24, 80).astype(np.float32)
    np.testing.assert_array_equal(depth_metrics.batch_post_process_disparity(l_disp, r_disp),
                                  jax_metrics.batch_post_process_disparity(l_disp, r_disp))


@pytest.fixture(scope="module")
def evaluators(tmp_path_factory):
    """Both packages' predict functions and val datasets, with the same
    weights."""
    info = make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=8, height=96,
                           width=320, scene="parallax")
    data = dict(name="kitti", split="synthetic", height=64, width=128, in_path=info["root"],
                gt_depth_path=info["gt_depth_path"])
    jmodel = build_model(JaxModelConfig(**MODEL))
    params, stats = _random_variables(jmodel, dummy_train_inputs(JaxModelConfig(**MODEL), 1))
    variables = {"params": params, "batch_stats": stats}
    with kernels_not_drawn():  # the load overwrites every parameter
        model = TripleDNet(ModelConfig(**MODEL))
    load_jax_variables(model, jax.tree_util.tree_map(np.asarray, params),
                       jax.tree_util.tree_map(np.asarray, stats))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TRIPLED_NATIVE_LOADER", "0")
        jds = jax_get_dataset(JaxDataConfig(**data), training=False, split_file=info["val_split"])
    pds = get_dataset(DataConfig(**data), training=False, split_file=info["val_split"])
    assert len(pds) == len(jds) == 6
    return jax_make_predict_fn(jmodel), variables, jds, make_predict_fn(model), pds


@pytest.mark.parametrize("pp", [False, True], ids=["plain", "flip_pp"])
def test_depth_evaluator_matches_jax(evaluators, pp):
    jax_predict, variables, jds, predict, pds = evaluators
    # batch 4 over 6 images: the second batch is padded
    want = JaxDepthEvaluator(jax_predict, jds, batch_size=4, flip_post_process=pp,
                             shard_across_processes=False).run(variables)
    got = DepthEvaluator(predict, pds, batch_size=4, flip_post_process=pp, device="cpu").run()
    assert set(got) == set(want)
    for k in depth_metrics.METRIC_NAMES + ("scale_ratio_med",):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=0, err_msg=k)
        assert np.isfinite(got[k])
    # the metrics see a depth map, not a constant
    assert 0 < got["a1"] < 1 and got["abs_rel"] > 0
