"""The port's host input fast path against the JAX package's, bit for bit,
on a synthetic KITTI tree (96x320, 10 frames): `sample` of the raw and
inpaint KITTI datasets, train and val, with the decode cache on and off,
under the same TRIPLED_NATIVE_LOADER (the native loader on and off) and
seed, with `device_color_aug` and `ship_uint8` in each allowed
combination. Every key is compared, `jitter_params` and `mask` included,
with its dtype. Also: the ValueError for `ship_uint8` without
`device_color_aug` in training, the decoder counts (native, and PIL where
the native loader is off or cannot read a file), and uint8 batches through
`BatchLoader` and `prefetch_to_device` on the CPU. The JAX native loader
is steadied first (`test_torch_port_native_loader.py`).
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_port_native_loader import steady_jax_native_loader
from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.data import datasets as jax_datasets
from tripled_tpu.data.get_dataset import get_dataset as jax_get_dataset
from tripled_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from tripled_tpu_torch.config import DataConfig
from tripled_tpu_torch.data import datasets
from tripled_tpu_torch.data.get_dataset import get_dataset
from tripled_tpu_torch.data.pipeline import BatchLoader, prefetch_to_device
from tripled_tpu_torch.data.synthetic import make_kitti_tree

torch.set_num_threads(1)

H, W = 48, 160
SEEDS = [0, 1, 2, 5, 6, 11]  # their first two draws cover jitter and flip, each on and off
# (device_color_aug, ship_uint8)
MODES = {"host": (False, False), "device_jitter": (True, False), "uint8": (True, True)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.delenv("TRIPLED_DECODE_CACHE_MB", raising=False)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loader():
    # the JAX loader's in-place build can race other workers' at collection
    steady_jax_native_loader()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=10, height=96,
                           width=320)


def _data_kw(tree, **kw):
    return dict(name="kitti_inpaint", split="synthetic", height=H, width=W,
                in_path=tree["root"], gt_depth_path=tree["gt_depth_path"], batch_size=2,
                erase_count=3, erase_shape=(8, 8), **kw)


def _pair(tree, name, training, **kw):
    split = tree["train_split" if training else "val_split"]
    jds = jax_get_dataset(JaxDataConfig(**_data_kw(tree, **kw) | {"name": name}),
                          training=training, split_file=split)
    pds = get_dataset(DataConfig(**_data_kw(tree, **kw) | {"name": name}),
                      training=training, split_file=split)
    return jds, pds


def _assert_samples_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("native", ["1", "0"], ids=["native", "pil"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("cache_mb", [0, 64], ids=["nocache", "cache"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("name", ["kitti", "kitti_inpaint"])
def test_sample_matches_jax(tree, monkeypatch, name, training, cache_mb, mode, native):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", native)
    device_color_aug, ship_uint8 = MODES[mode]
    jds, pds = _pair(tree, name, training, decode_cache_mb=cache_mb,
                     device_color_aug=device_color_aug, ship_uint8=ship_uint8)
    assert pds.use_native == jds.use_native == (native == "1")
    applied = set()
    # twice over, so that the second pass reads the cache where it is on
    for _ in range(2 if cache_mb else 1):
        for seed in SEEDS:
            index = seed % len(pds)
            a = jds.sample(index, np.random.RandomState(seed))
            b = pds.sample(index, np.random.RandomState(seed))
            _assert_samples_equal(a, b)
            assert b["color"].dtype == (np.uint8 if ship_uint8 else np.float32)
            if "jitter_params" in b:
                applied.add(float(b["jitter_params"][8]))
    keys = set(b)
    assert ("mask" in keys) == (name == "kitti_inpaint")
    assert ("jitter_params" in keys) == (training and device_color_aug)
    assert ("color_aug" in keys) == (not (training and device_color_aug))
    if training and device_color_aug:
        assert applied == {0.0, 1.0}
    decoded = pds.counters["decodes_native" if native == "1" else "decodes_pil"]
    assert decoded > 0 and sum(pds.counters.values()) == decoded


def test_ship_uint8_needs_device_color_aug_in_training(tree):
    for make in (lambda **kw: _pair(tree, "kitti", True, **kw)[1],
                 lambda **kw: _pair(tree, "kitti", True, **kw)[0]):
        with pytest.raises(ValueError, match="device_color_aug"):
            make(ship_uint8=True)
    # evaluation has no jitter: uint8 frames need nothing more
    _, pds = _pair(tree, "kitti", False, ship_uint8=True)
    s = pds.sample(0, np.random.RandomState(0))
    assert s["color"].dtype == s["color_aug"].dtype == np.uint8


def test_lab_from_uint8_frames_matches_jax(tree, monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "1")
    jds, pds = _pair(tree, "kitti", True, add_lab=True, device_color_aug=True,
                     ship_uint8=True)
    for seed in SEEDS[:3]:
        _assert_samples_equal(jds.sample(1, np.random.RandomState(seed)),
                              pds.sample(1, np.random.RandomState(seed)))


def test_pil_takes_files_the_native_loader_cannot_read(tree, tmp_path, monkeypatch):
    """A BMP frame: libpng and libjpeg refuse it, PIL decodes it, and the
    dataset counts one decode of each kind."""
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "1")
    src = os.path.join(tree["root"], tree["scene"], "image_02", "data")
    first, second = sorted(os.listdir(src))[:2]
    Image.open(os.path.join(src, first)).save(tmp_path / "a.bmp")
    Image.open(os.path.join(src, second)).save(tmp_path / "b.png")
    kw = dict(height=H, width=W, frame_ids=(0,), is_train=False)
    pds = datasets.FolderDataset(str(tmp_path), cfg=DataConfig(), **kw)
    jds = jax_datasets.FolderDataset(str(tmp_path), cfg=JaxDataConfig(), **kw)
    assert pds.use_native
    for index in (0, 1):
        _assert_samples_equal(jds.sample(index, np.random.RandomState(0)),
                              pds.sample(index, np.random.RandomState(0)))
    assert pds.counters == {"decodes_native": 1, "decodes_pil": 1}


@pytest.mark.parametrize("num_workers", [1, 4])
def test_uint8_batches_keep_their_dtypes(tree, monkeypatch, num_workers):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "1")
    jds, pds = _pair(tree, "kitti_inpaint", True, device_color_aug=True, ship_uint8=True,
                     decode_cache_mb=64)
    jl = JaxBatchLoader(jds, batch_size=3, seed=7, num_workers=num_workers)
    pl = BatchLoader(pds, batch_size=3, seed=7, num_workers=num_workers)
    host = list(pl)
    for a, b in zip(list(jl), host):
        _assert_samples_equal(a, b)
    assert len(host) == 2
    for h, d in zip(host, prefetch_to_device(iter(host), "cpu")):
        assert sorted(d) == ["K", "color", "inv_K", "jitter_params", "mask"]
        assert d["color"].dtype == torch.uint8 and d["color"].shape == (3, 3, H, W, 3)
        assert d["jitter_params"].dtype == torch.float32 and d["jitter_params"].shape == (3, 9)
        for k, v in d.items():
            assert torch.equal(v, torch.from_numpy(h[k])), k


def test_cache_makes_both_decoders_equal(tree, monkeypatch):
    """With the decode cache on, native and PIL samples are the same bytes
    (the cache rounds to PIL's uint8 grid)."""
    samples = {}
    for native in ("1", "0"):
        monkeypatch.setenv("TRIPLED_NATIVE_LOADER", native)
        _, pds = _pair(tree, "kitti_inpaint", True, decode_cache_mb=64)
        samples[native] = [pds.sample(s % len(pds), np.random.RandomState(s)) for s in SEEDS]
    for a, b in zip(samples["1"], samples["0"]):
        _assert_samples_equal(a, b)
