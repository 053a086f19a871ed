"""The port's data layer against the JAX package's, bit for bit, on a
synthetic KITTI tree (96x320, 10 frames): the trees the two
`synthetic.py` write, ColorJitter, `sample` of the raw and inpaint KITTI
datasets (train and val, with and without the decode cache), the folder
dataset, `BatchLoader`'s epochs and batches, and `get_dataset`'s names.

Every JAX dataset here is built with TRIPLED_NATIVE_LOADER=0: the JAX
package otherwise decodes with its optional g++ loader, and the port, like
the JAX package without that loader, decodes with PIL.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.data import datasets as jax_datasets
from tripled_tpu.data.get_dataset import _DATASETS as JAX_DATASETS
from tripled_tpu.data.get_dataset import get_dataset as jax_get_dataset
from tripled_tpu.data import transforms as jax_transforms
from tripled_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from tripled_tpu.data.synthetic import make_kitti_tree as jax_make_kitti_tree
from tripled_tpu_torch.config import DataConfig
from tripled_tpu_torch.data import datasets, transforms
from tripled_tpu_torch.data.get_dataset import _DATASETS, get_dataset
from tripled_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from tripled_tpu_torch.data.readers import readlines
from tripled_tpu_torch.data.synthetic import make_kitti_tree

torch.set_num_threads(1)

H, W = 48, 160  # the datasets' output size; the tree is 96x320
# seeds whose first two draws cover jitter and flip, each on and off
SEEDS = [0, 1, 2, 5, 6, 11]


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")
    monkeypatch.delenv("TRIPLED_DECODE_CACHE_MB", raising=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=10, height=96,
                           width=320)


def _data_kw(tree, **kw):
    return dict(name="kitti_inpaint", split="synthetic", height=H, width=W,
                in_path=tree["root"], gt_depth_path=tree["gt_depth_path"], batch_size=2,
                erase_count=3, erase_shape=(8, 8), **kw)


def _both(tree, **kw):
    return JaxDataConfig(**_data_kw(tree, **kw)), DataConfig(**_data_kw(tree, **kw))


def _assert_samples_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("scene", ["translate", "parallax"])
def test_synthetic_tree_matches_jax(scene, tmp_path):
    kw = dict(num_frames=4, height=96, width=320, scene=scene)
    jax_info = jax_make_kitti_tree(str(tmp_path / "jax"), **kw)
    info = make_kitti_tree(str(tmp_path / "port"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), info["root"])
                   for d, _, fs in os.walk(info["root"]) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), jax_info["root"])
                           for d, _, fs in os.walk(jax_info["root"]) for f in fs)
    for rel in files:
        a, b = os.path.join(jax_info["root"], rel), os.path.join(info["root"], rel)
        if rel.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
        elif rel.endswith(".npz"):
            ga, gb = np.load(a, allow_pickle=True)["data"], np.load(b, allow_pickle=True)["data"]
            assert len(ga) == len(gb)
            for x, y in zip(ga, gb):
                np.testing.assert_array_equal(x, y)
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel
    assert {k: v for k, v in info.items() if k != "root" and not isinstance(v, str)} == \
        {k: v for k, v in jax_info.items() if k != "root" and not isinstance(v, str)}


@pytest.mark.parametrize("seed", range(4))
def test_color_jitter_matches_jax(seed):
    x = np.random.RandomState(100 + seed).rand(2, 24, 40, 3).astype(np.float32)
    factors = {}
    for name, mod in (("jax", jax_transforms), ("port", transforms)):
        rng = np.random.RandomState(seed)
        apply = mod.ColorJitter().sample(rng)
        factors[name] = (rng.get_state()[2], np.stack([apply(c) for c in x]))
    assert factors["jax"][0] == factors["port"][0]  # the same number of draws
    np.testing.assert_array_equal(factors["jax"][1], factors["port"][1])
    for fn, arg in [("adjust_brightness", 1.13), ("adjust_contrast", 0.87),
                    ("adjust_saturation", 1.19), ("adjust_hue", -0.07)]:
        np.testing.assert_array_equal(getattr(jax_transforms, fn)(x, arg),
                                      getattr(transforms, fn)(x, arg), err_msg=fn)


@pytest.mark.parametrize("name", ["kitti", "kitti_inpaint"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("cache_mb", [0, 64], ids=["nocache", "cache"])
def test_sample_matches_jax(tree, name, training, cache_mb):
    jcfg, pcfg = _both(tree, decode_cache_mb=cache_mb)
    jcfg, pcfg = (dataclasses.replace(c, name=name) for c in (jcfg, pcfg))
    split = tree["train_split" if training else "val_split"]
    jds = jax_get_dataset(jcfg, training=training, split_file=split)
    pds = get_dataset(pcfg, training=training, split_file=split)
    assert type(pds).__name__ == type(jds).__name__
    assert len(pds) == len(jds) == 8
    flips = set()
    # twice over, so that the second pass reads the cache where it is on
    for _ in range(2 if cache_mb else 1):
        for seed in SEEDS:
            index = seed % len(pds)
            a = jds.sample(index, np.random.RandomState(seed))
            b = pds.sample(index, np.random.RandomState(seed))
            _assert_samples_equal(a, b)
            if training:
                rng = np.random.RandomState(seed)
                flips.add((rng.rand() > 0.5, rng.rand() > 0.5))
    if training:
        assert flips == {(False, False), (False, True), (True, False), (True, True)}
    keys = set(pds.sample(0, np.random.RandomState(0)))
    assert ("mask" in keys) == (name == "kitti_inpaint")
    assert ("gt_depth" in keys) == (not training)


def test_lab_sample_matches_jax(tree):
    jcfg, pcfg = _both(tree, add_lab=True)
    jds = jax_get_dataset(jcfg, training=True, split_file=tree["train_split"])
    pds = get_dataset(pcfg, training=True, split_file=tree["train_split"])
    for seed in SEEDS[:3]:
        b = pds.sample(1, np.random.RandomState(seed))
        _assert_samples_equal(jds.sample(1, np.random.RandomState(seed)), b)
        assert b["color_lab"].shape == (3, H, W, 3)


def test_folder_dataset_matches_jax(tree):
    folder = os.path.join(tree["root"], tree["scene"], "image_02", "data")
    kw = dict(height=H, width=W, frame_ids=(0, -1, 1), is_train=True)
    jds = jax_datasets.FolderDataset(folder, cfg=JaxDataConfig(), **kw)
    pds = datasets.FolderDataset(folder, cfg=DataConfig(), **kw)
    assert pds.filenames == jds.filenames and len(pds) == 10
    for seed, index in [(0, 0), (1, 4), (2, 9), (3, 5)]:
        _assert_samples_equal(jds.sample(index, np.random.RandomState(seed)),
                              pds.sample(index, np.random.RandomState(seed)))


@pytest.mark.parametrize("num_workers", [1, 4])
def test_batch_loader_matches_jax(tree, num_workers):
    jcfg, pcfg = _both(tree)
    jds = jax_get_dataset(jcfg, training=True, split_file=tree["train_split"])
    pds = get_dataset(pcfg, training=True, split_file=tree["train_split"])
    jl = JaxBatchLoader(jds, batch_size=3, seed=7, num_workers=num_workers)
    pl = BatchLoader(pds, batch_size=3, seed=7, num_workers=num_workers)
    assert len(pl) == len(jl) == 2  # 8 lines, drop_last
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        np.testing.assert_array_equal(pl._epoch_indices(), jl._epoch_indices())
        jb, pb = list(jl), list(pl)
        assert len(jb) == len(pb) == 2
        for a, b in zip(jb, pb):
            _assert_samples_equal(a, b)
            assert a["color"].shape == (3, 3, H, W, 3)


def test_get_dataset_names(tree, monkeypatch):
    monkeypatch.setenv("TRIPLED_SPLITS_DIR", tree["splits_dir"])
    for name in ("kitti", "kitti_inpaint", "kitti_map", "kitti_odom", "kitti_depth", "folder",
                 "eth3d", "euroc"):
        assert _DATASETS[name].__name__ == JAX_DATASETS[name].__name__
    with pytest.raises(KeyError, match="later slice"):
        get_dataset(DataConfig(**_data_kw(tree) | {"name": "cityscape"}))
    with pytest.raises(KeyError, match="unknown dataset"):
        get_dataset(DataConfig(**_data_kw(tree) | {"name": "nope"}))
    # the split comes from $TRIPLED_SPLITS_DIR, as in the JAX package
    ds = get_dataset(DataConfig(**_data_kw(tree)), training=False)
    assert ds.filenames == readlines(tree["val_split"])
    assert ds.frame_ids == (0,) and ds.gt_depths is not None


def test_unported_data_options_raise(tree):
    """Both options are ported (test_torch_port_data_fast.py); what still
    raises is the JAX package's refusal of uint8 frames for the host
    ColorJitter."""
    with pytest.raises(ValueError, match="device_color_aug"):
        get_dataset(DataConfig(**_data_kw(tree) | {"ship_uint8": True}), training=True,
                    split_file=tree["train_split"])
    for flags in ({"device_color_aug": True}, {"device_color_aug": True, "ship_uint8": True}):
        get_dataset(DataConfig(**_data_kw(tree) | flags), training=True,
                    split_file=tree["train_split"])


def test_prefetch_on_the_cpu_converts_and_raises(tree):
    """On a CPU device prefetch_to_device only converts the arrays (the
    card's copy-stream path is held in test_torch_port_cuda.py)."""
    ds = get_dataset(DataConfig(**_data_kw(tree)), training=False, split_file=tree["val_split"])
    host = list(BatchLoader(ds, batch_size=4, shuffle=False, num_workers=1))
    got = list(prefetch_to_device(iter(host), "cpu"))
    assert len(got) == 2
    for h, d in zip(host, got):
        assert d["gt_depth"] is h["gt_depth"]
        for k in ("color", "K", "inv_K", "color_aug", "mask"):
            assert torch.equal(d[k], torch.from_numpy(h[k])), k

    def broken():
        yield host[0]
        raise ValueError("broken sample")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(ValueError, match="broken sample"):
        next(it)
