"""The segmentation slice of tripled_tpu_torch against the JAX package, on
the CPU, inputs made from a numpy seed:

- the Cityscapes label table, the train-id LUT and the void id, equal;
- every joint transform of `data/seg_transforms.py`, alone and composed,
  bit-equal under the same `np.random.RandomState`, which both leave in the
  same state;
- the synthetic KITTI semseg tree equal to the one the JAX package's
  `tests/test_seg_train_cli.py` writes, file for file;
- both dataset layouts (KITTI semseg and Cityscapes), train and test
  transforms, bit-equal samples and batches;
- `SegmentationRunningScore` and `Evaluator` equal on random confusions
  (void counted as a class, labels out of range dropped);
- each of the three `SEGMENTATION` models (R18, 64x96, batch 2, float64,
  the JAX variables carried over by `load_jax_variables`, strictly): the
  eval-mode log-probabilities within 1e-9, the scores of the test split
  equal to the JAX hook's where the label has the image's size, and one
  train step within TOL_F64 (`test_torch_port_flagship_f64.py`): the loss,
  the train-mode log-probabilities (1e-9), each tensor's gradient, the
  parameters after Adam and the BatchNorm statistics. Under
  FixSegmentationDepth the encoder's gradient is zero in both, and its
  BatchNorm statistics move in both.

The JAX package has no segmentation train step of its own: its CLI writes
one inline (`tripled_tpu/cli/train_segmentation.py:102-119`), which
`_jax_step` repeats. One compile per model: the step and the eval forward
in one jitted function.
"""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from test_seg_train_cli import _make_seg_tree
from test_torch_port_flagship_f64 import TOL_F64
from test_torch_port_step import (
    _random_variables,
    check_against_jax,
    kernels_not_drawn,
    release_jax_memory,
)
from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.config import ModelConfig as JaxModelConfig
from tripled_tpu.config import OptimConfig as JaxOptimConfig
from tripled_tpu.data import cityscapes_labels as jax_labels
from tripled_tpu.data import seg_datasets as jax_seg_datasets
from tripled_tpu.data import seg_transforms as JST
from tripled_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from tripled_tpu.eval import segmentation_metrics as jax_metrics
from tripled_tpu.models.segmentation import build_segmentation_model as jax_build
from tripled_tpu.train.optim import make_optimizer
from tripled_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from tripled_tpu_torch.data import cityscapes_labels as labels
from tripled_tpu_torch.data import seg_datasets
from tripled_tpu_torch.data import seg_transforms as ST
from tripled_tpu_torch.data.pipeline import BatchLoader
from tripled_tpu_torch.data.synthetic import make_cityscapes_seg_tree, make_kitti_seg_tree
from tripled_tpu_torch.eval import segmentation_metrics as metrics
from tripled_tpu_torch.models.segmentation import SEGMENTATION, build_segmentation_model
from tripled_tpu_torch.train.optim import Adam
from tripled_tpu_torch.train.step import make_segmentation_train_step
from tripled_tpu_torch.utils.jax_weights import load_jax_variables

torch.set_num_threads(1)

B, H, W = 2, 64, 96
STEPS_PER_EPOCH = 100
SEEDS = [0, 1, 2, 3, 4, 5]


def test_label_table_matches_jax():
    assert labels.VOID_TRAIN_ID == jax_labels.VOID_TRAIN_ID == 19
    assert [dataclasses.astuple(x) for x in labels.getlabels()] == \
        [dataclasses.astuple(x) for x in jax_labels.getlabels()]
    assert {k: dataclasses.astuple(v) for k, v in labels.gettrainid2label().items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_labels.gettrainid2label().items()}
    lut = labels.id_to_trainid_lut()
    assert lut.dtype == np.uint8
    np.testing.assert_array_equal(lut, jax_labels.id_to_trainid_lut())
    assert [labels.num_train_classes(v) for v in (True, False)] == [20, 19]


def _transforms(ns):
    """Every transform of the module (`ns`: either package's), several
    with their coins forced both ways, and the chains of both train sets."""
    return {
        "resize": ns.Resize((40, 56)),
        "resize_only_img": ns.Resize((40, 56), only_img=True),
        "rescale": ns.RandomRescale(1.5),
        "crop": ns.RandomCrop((40, 56)),
        "crop_larger": ns.RandomCrop((80, 120)),
        "center_crop": ns.CenterCrop((40, 56)),
        "hflip": ns.RandomHorizontalFlip(0.5),
        "vflip": ns.RandomVerticalFlip(0.5),
        "rotate": ns.RandomRotate(10.0),
        "convert": ns.ConvertSegmentation(),
        "jitter": ns.ColorJitter(0.2, 0.2, 0.2, 0.1, gamma=0.0, fraction=0.5),
        "jitter_gamma": ns.ColorJitter(0.4, 0.3, 1.2, 0.6, gamma=0.5, fraction=1.0),
        "blur": ns.GaussianBlur(1.0, p=0.5),
        "normalize": ns.NormalizeZeroMean(),
        "kitti_train": ns.Compose([ns.RandomHorizontalFlip(0.5), ns.Resize((40, 56)),
                                   ns.ConvertSegmentation(),
                                   ns.ColorJitter(0.2, 0.2, 0.2, 0.1, gamma=0.0, fraction=0.5),
                                   ns.NormalizeZeroMean()]),
        "cityscapes_train": ns.Compose([
            ns.RandomHorizontalFlip(0.5), ns.Resize((96, 128)), ns.RandomRescale(1.5),
            ns.RandomCrop((40, 56)), ns.ConvertSegmentation(),
            ns.ColorJitter(0.2, 0.2, 0.2, 0.1, gamma=0.0, fraction=0.2), ns.NormalizeZeroMean()]),
        "everything": ns.Compose([
            ns.RandomVerticalFlip(0.5), ns.RandomRotate(5.0), ns.CenterCrop((60, 90)),
            ns.GaussianBlur(2.0, p=0.7), ns.ColorJitter(gamma=0.2, fraction=0.9),
            ns.ConvertSegmentation(), ns.NormalizeZeroMean()]),
    }


def _sample(seed, with_label=True):
    rng = np.random.RandomState(100 + seed)
    s = {"image": rng.rand(64, 96, 3).astype(np.float32),
         "label": rng.randint(0, 34, (64, 96)).astype(np.int32) if with_label else None}
    return s


@pytest.mark.parametrize("name", list(_transforms(ST)))
def test_transform_matches_jax_bit_for_bit(name):
    port, ref = _transforms(ST)[name], _transforms(JST)[name]
    outcomes = set()
    for seed in SEEDS:
        for with_label in (True, False):
            r1, r2 = np.random.RandomState(seed), np.random.RandomState(seed)
            got, want = port(_sample(seed, with_label), r1), ref(_sample(seed, with_label), r2)
            assert set(got) == set(want)
            for k in want:
                if want[k] is None:
                    assert got[k] is None
                    continue
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k} {seed}")
            assert r1.randint(1 << 30) == r2.randint(1 << 30)  # same draws consumed
            outcomes.add(got["image"].tobytes() == _sample(seed)["image"].tobytes())
    if name in ("hflip", "vflip", "jitter", "blur"):
        assert outcomes == {True, False}  # the coin fell both ways


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    return make_kitti_seg_tree(str(tmp_path_factory.mktemp("kitti_seg")), num_frames=10,
                               height=H, width=W)


@pytest.fixture(scope="module")
def cityscapes_tree(tmp_path_factory):
    return make_cityscapes_seg_tree(str(tmp_path_factory.mktemp("cityscapes")),
                                    {"train": 4, "val": 2, "test": 3}, height=96, width=192,
                                    block=8)


def test_kitti_seg_tree_is_the_jax_tests_tree(kitti_tree, tmp_path):
    ref = _make_seg_tree(str(tmp_path / "jax"), n=10, h=H, w=W)
    for sub in ("image_2", "semantic"):
        for i in range(10):
            name = f"training/{sub}/{i:06d}_10.png"
            with open(f"{kitti_tree}/{name}", "rb") as a, open(f"{ref}/{name}", "rb") as b:
                assert a.read() == b.read(), name


def _data_cfgs(name, root):
    kw = dict(name=name, in_path=root, height=H, width=W, batch_size=B)
    return DataConfig(**kw), JaxDataConfig(**kw)


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("split", ["train", "test", "val"])
@pytest.mark.parametrize("layout", ["kitti", "cityscapes"])
def test_dataset_samples_match_jax(layout, split, kitti_tree, cityscapes_tree):
    root = kitti_tree if layout == "kitti" else cityscapes_tree
    cfg, jcfg = _data_cfgs(layout, root)
    if split == "train":
        port = seg_datasets.get_segmentation_train_dataset(cfg)
        ref = jax_seg_datasets.get_segmentation_train_dataset(jcfg)
    else:
        port = seg_datasets.get_test_segmentation_dataset(cfg, val=split == "val")
        ref = jax_seg_datasets.get_test_segmentation_dataset(jcfg, val=split == "val")
    want_len = {"kitti": {"train": 8, "test": 2, "val": 2},
                "cityscapes": {"train": 4, "test": 3, "val": 2}}[layout][split]
    assert len(port) == len(ref) == want_len
    for i in range(len(ref)):
        for seed in SEEDS[:3]:
            got = port.sample(i, np.random.RandomState(seed))
            want = ref.sample(i, np.random.RandomState(seed))
            _assert_samples_equal(got, want)
            assert got["image"].shape == (H, W, 3)
            # the test transform leaves the label at its source size
            want_label = (H, W) if split == "train" or layout == "kitti" else (96, 192)
            assert got["label"].shape == want_label
            assert got["label"].max() <= labels.VOID_TRAIN_ID


@pytest.mark.parametrize("layout", ["kitti", "cityscapes"])
def test_batches_match_jax(layout, kitti_tree, cityscapes_tree):
    root = kitti_tree if layout == "kitti" else cityscapes_tree
    cfg, jcfg = _data_cfgs(layout, root)
    port = BatchLoader(seg_datasets.get_segmentation_train_dataset(cfg), B, seed=7)
    ref = JaxBatchLoader(jax_seg_datasets.get_segmentation_train_dataset(jcfg), B, seed=7)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) >= 2
        for g, w in zip(got, want):
            _assert_samples_equal(g, w)


def test_running_score_and_evaluator_match_jax():
    rng = np.random.RandomState(3)
    port, ref = metrics.SegmentationRunningScore(20), jax_metrics.SegmentationRunningScore(20)
    for _ in range(4):
        # labels past the classes (and below 0) are dropped by both
        truth = rng.randint(-1, 23, (2, 24, 40))
        pred = rng.randint(0, 20, (2, 24, 40))
        pred[truth == 3] = 3  # one class always right
        truth[truth == 5] = 6  # one class never in the truth
        port.update(truth, pred)
        ref.update(truth, pred)
    np.testing.assert_array_equal(port.confusion_matrix, ref.confusion_matrix)
    assert port.confusion_matrix[19].sum() > 0  # void is a class
    got, want = port.get_scores(), ref.get_scores()
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "iou":
            assert list(got[k]) == list(want[k])
            np.testing.assert_array_equal(list(got[k].values()), list(want[k].values()))
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the Evaluator's statics on a confusion with an empty row and column
    conf = rng.randint(0, 50, (6, 6)).astype(np.float64)
    conf[2], conf[:, 4] = 0, 0
    for fn in ("iou", "accuracy", "precision", "freqwacc"):
        got, want = getattr(metrics.Evaluator, fn)(conf), getattr(jax_metrics.Evaluator, fn)(conf)
        for k in want:
            g, w = got[k], want[k]
            if isinstance(w, dict):
                g, w = list(g.values()), list(w.values())
            np.testing.assert_array_equal(g, w, err_msg=f"{fn} {k}")
    port.reset()
    assert not port.confusion_matrix.any()


def test_predict_labels_resizes_only_a_differing_size():
    lp = torch.from_numpy(np.random.RandomState(0).randn(1, 8, 12, 5))
    np.testing.assert_array_equal(metrics.predict_labels(lp, 8, 12).numpy(),
                                  lp.argmax(-1).numpy())
    up = metrics.predict_labels(lp, 32, 48)
    assert up.shape == (1, 32, 48)


def _model_kwargs():
    return dict(depth_num_layers=18, extractor_num_layers=18, height=H, width=W)


def _jax_step(model, tx):
    """The JAX CLI's train step (`train_segmentation.py:102-119`), which
    also returns the train-mode log-probabilities and the gradient norm,
    and the eval forward on the step's starting variables."""

    def step(params, stats, opt_state, batch, eval_image):
        def loss_fn(params):
            (out, ld), mut = model.apply({"params": params, "batch_stats": stats}, batch,
                                         train=True, mutable=["batch_stats"])
            return ld["seg_ce_loss"], (mut["batch_stats"], out["log_probs"])

        (loss, (new_stats, log_probs)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        eval_lp = model.apply({"params": params, "batch_stats": stats}, {"image": eval_image},
                              train=False)
        return (loss, optax.global_norm(grads), log_probs, optax.apply_updates(params, updates),
                new_stats, new_opt, eval_lp)

    return jax.jit(step)


@pytest.mark.parametrize("name", list(SEGMENTATION))
def test_segmentation_model_float64_matches_jax(name, kitti_tree):
    rng = np.random.RandomState(11)
    batch = {"image": rng.randn(B, H, W, 3),
             "label": rng.randint(0, 20, (B, H, W)).astype(np.int32)}
    cfg, jcfg = _data_cfgs("kitti", kitti_tree)
    test_ds = seg_datasets.get_test_segmentation_dataset(cfg)
    jax_test_ds = jax_seg_datasets.get_test_segmentation_dataset(jcfg)
    eval_samples = [jax_test_ds.sample(i, np.random.RandomState(0))
                    for i in range(len(jax_test_ds))]
    eval_image = np.stack([s["image"] for s in eval_samples]).astype(np.float64)

    with jax.enable_x64(True):
        jmodel = jax_build(JaxModelConfig(**_model_kwargs()), name, 20)
        params, stats = _random_variables(jmodel, batch, np.float64)
        tx, _ = make_optimizer(JaxOptimConfig(warmup_iters=2), steps_per_epoch=STEPS_PER_EPOCH)
        out = _jax_step(jmodel, tx)(params, stats, tx.init(params), batch, eval_image)
        loss, gnorm, j_lp, new_params, new_stats, new_opt, j_eval = jax.tree_util.tree_map(
            np.asarray, out)
    jm = {"seg_ce_loss": float(loss), "grad_norm": float(gnorm)}
    # the JAX gradient from Adam's first moment (no weight decay; norm < 35)
    assert jm["grad_norm"] < 35.0
    (adam,) = [s for s in jax.tree_util.tree_leaves(new_opt, is_leaf=lambda s: hasattr(s, "mu"))
               if hasattr(s, "mu")]
    jgrad_tree = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, adam.mu)
    del out, new_opt, adam
    release_jax_memory()

    def port_model(p, s):
        with kernels_not_drawn():  # the load overwrites every parameter
            m = build_segmentation_model(ModelConfig(**_model_kwargs()), name, 20).double()
        load_jax_variables(m, p, s)  # strict: nothing unused, nothing unwritten
        return m

    model = port_model(params, stats)
    # eval mode: log-probabilities, and the hook's scores (sizes match here)
    model.eval()
    with torch.no_grad():
        lp = model({"image": torch.from_numpy(eval_image)})
    assert lp.shape == (len(eval_samples), H, W, 20)
    np.testing.assert_allclose(lp.numpy(), j_eval, rtol=0, atol=1e-9)
    want = jax_metrics.SegmentationRunningScore(20)
    for s, j in zip(eval_samples, j_eval):
        want.update(s["label"][None], j.argmax(-1)[None])
    got = metrics.evaluate_segmentation(model, test_ds, 20, "cpu")
    np.testing.assert_array_equal(got.confusion_matrix, want.confusion_matrix)
    assert got.get_scores()["meaniou"] == want.get_scores()["meaniou"]

    # one train step
    optimizer = Adam(model, OptimConfig(warmup_iters=2), STEPS_PER_EPOCH)
    tm, outputs = make_segmentation_train_step(model, optimizer)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    tm = {k: float(v) for k, v in tm.items()}
    np.testing.assert_allclose(outputs["log_probs"].numpy(), j_lp, rtol=0, atol=1e-9)
    ref, jgrads = port_model(new_params, new_stats), port_model(jgrad_tree, stats)
    check_against_jax(jm, tm, model, ref, jgrads, automask=False, tol=TOL_F64)
    enc_grads = [p.grad for p in model.encoder.parameters()]
    if name == "FixSegmentationDepth":
        assert all(g is None for g in enc_grads)
        assert all(not p.detach().any() for p in jgrads.encoder.parameters())
    else:
        assert all(g is not None and g.abs().max() > 0 for g in enc_grads)
    # the encoder's BatchNorm statistics moved in both packages
    before = port_model(params, stats).encoder.state_dict()
    moved = [k for k, v in model.encoder.state_dict().items()
             if "running" in k and not torch.equal(v, before[k])]
    assert len(moved) == len([k for k in before if "running" in k])
