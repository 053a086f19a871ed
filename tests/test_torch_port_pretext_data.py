"""The pieces of the pretext presets that are not networks, against the
JAX package's, on the CPU (no JAX step runs here):

- `motion_mask` and `_otsu` bit-equal, on float frames and on uint8 frames
  (DataConfig.ship_uint8, which both packages scale by 255 once more);
- `KITTIMapDataset` samples bit-equal on a synthetic KITTI tree (map
  masks, map params and the inpaint mask, with the shipped alphas and the
  default ones), and through `BatchLoader`; a validation sample, on which
  the JAX dataset raises, without the map keys;
- the nearest-sample warp equal to the JAX one, on exact .5 ties too, where
  `F.grid_sample(mode="nearest")` rounds half to even;
- the area resize at the shipped rotation pretext's non-integer factors
  (320x1024 to a 224 crop's stage sizes) against the JAX one;
- rot90 of each k against `jnp.rot90`, the batch-softmax cross entropy
  against the JAX one (value and gradient), and `draw_pretext`'s ranges
  and determinism;
- the rotation pretext under remat: one draw a step, and remat on equal to
  remat off, bit for bit (the port alone).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tripled_tpu.config import DataConfig as JaxDataConfig
from tripled_tpu.data import transforms as jax_transforms
from tripled_tpu.data.get_dataset import get_dataset as jax_get_dataset
from tripled_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from tripled_tpu.models import aux_nets as jax_aux
from tripled_tpu.ops.image import resize_area as jax_resize_area
from tripled_tpu.ops.warp import grid_sample as jax_grid_sample
from test_torch_port_pretext_steps import pretext_inputs, pretext_kwargs
from tripled_tpu_torch.config import DataConfig, ModelConfig, OptimConfig
from tripled_tpu_torch.data import transforms
from tripled_tpu_torch.data.get_dataset import get_dataset
from tripled_tpu_torch.data.pipeline import BatchLoader
from tripled_tpu_torch.data.synthetic import make_kitti_tree
from tripled_tpu_torch.models import aux_nets
from tripled_tpu_torch.ops.image import resize_area
from tripled_tpu_torch.ops.warp import grid_sample
from tripled_tpu_torch.train.state import create_train_state
from tripled_tpu_torch.train.step import make_train_step

torch.set_num_threads(1)

H, W = 48, 160
SEEDS = [0, 1, 2, 5, 6, 11]


@pytest.fixture(autouse=True)
def _pil_only(monkeypatch):
    monkeypatch.setenv("TRIPLED_NATIVE_LOADER", "0")
    monkeypatch.delenv("TRIPLED_DECODE_CACHE_MB", raising=False)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_kitti_tree(str(tmp_path_factory.mktemp("kitti")), num_frames=10, height=96,
                           width=320, scene="parallax")


def _frames(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    base = rng.rand(H, W, 3).astype(np.float32)
    moved = np.clip(base + 0.3 * (rng.rand(H, W, 3) > 0.9), 0, 1).astype(np.float32)
    moved[10:20, 30:60] = rng.rand(10, 30, 3)
    if dtype == np.uint8:
        return (base * 255).round().astype(np.uint8), (moved * 255).round().astype(np.uint8)
    return base, moved


@pytest.mark.parametrize("dtype", [np.float32, np.uint8], ids=["float", "uint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_motion_mask_bit_equal(seed, dtype):
    target, source = _frames(seed, dtype)
    got = transforms.motion_mask(target, source)
    want = jax_transforms.motion_mask(target, source)
    assert got.dtype == want.dtype == np.float32 and got.shape == (H, W, 1)
    np.testing.assert_array_equal(got, want)
    if dtype == np.float32:
        assert 0 < got.mean() < 1
    # a fixed threshold, and the Otsu threshold itself
    np.testing.assert_array_equal(transforms.motion_mask(target, source, threshold=20.0),
                                  jax_transforms.motion_mask(target, source, threshold=20.0))
    img = np.abs(target.astype(np.float32) - source.astype(np.float32)).mean(-1) * 40
    assert transforms._otsu(img) == jax_transforms._otsu(img)


def test_otsu_of_an_empty_histogram_is_zero():
    img = np.full((4, 4), 300.0, np.float32)  # past the 0-255 range
    assert transforms._otsu(img) == jax_transforms._otsu(img) == 0.0


def _map_kw(tree, **kw):
    return dict(dict(name="kitti_map", split="synthetic", height=H, width=W,
                     in_path=tree["root"], gt_depth_path=tree["gt_depth_path"], batch_size=2,
                     erase_count=3, erase_shape=(8, 8)), **kw)


def _assert_samples_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [dict(map_alphas=(0.1, 0.4, 0.7, 1.0)), dict(),
                                dict(map_alphas=(0.1, 0.4, 0.7, 1.0), device_color_aug=True,
                                     ship_uint8=True)],
                         ids=["shipped_alphas", "default_alphas", "ship_uint8"])
def test_map_dataset_samples_bit_equal(tree, kw):
    jds = jax_get_dataset(JaxDataConfig(**_map_kw(tree, **kw)), training=True,
                          split_file=tree["train_split"])
    pds = get_dataset(DataConfig(**_map_kw(tree, **kw)), training=True,
                      split_file=tree["train_split"])
    assert type(pds).__name__ == type(jds).__name__ == "KITTIMapDataset"
    alphas = kw.get("map_alphas") or (0.25, 0.5, 0.75, 1.0)
    labels = set()
    for seed in SEEDS:
        a = jds.sample(seed % len(pds), np.random.RandomState(seed))
        b = pds.sample(seed % len(pds), np.random.RandomState(seed))
        _assert_samples_equal(a, b)
        assert b["map_mask"].shape == (2, H, W, 1) and b["map_params"].shape == (2, 3)
        for label, a1, a2 in b["map_params"]:
            assert (a1, a2) == (np.float32(alphas[int(label) // 4]),
                                np.float32(alphas[int(label) % 4]))
            labels.add(int(label))
    assert len(labels) > 3
    assert pds.counters["motion_mask_cpu_s"] > 0


def test_map_dataset_batches_match_jax(tree):
    jds = jax_get_dataset(JaxDataConfig(**_map_kw(tree)), training=True,
                          split_file=tree["train_split"])
    pds = get_dataset(DataConfig(**_map_kw(tree)), training=True, split_file=tree["train_split"])
    jl = JaxBatchLoader(jds, batch_size=3, seed=7, num_workers=2)
    pl = BatchLoader(pds, batch_size=3, seed=7, num_workers=2)
    jb, pb = list(jl), list(pl)
    assert len(jb) == len(pb) == 2
    for a, b in zip(jb, pb):
        _assert_samples_equal(a, b)
        assert b["map_mask"].shape == (3, 2, H, W, 1)


def test_map_dataset_validation_sample_has_no_map_keys(tree):
    """The JAX dataset raises on a target-only sample (no masks to stack);
    the port's gives the sample without the map keys, so that the eval hook
    runs."""
    jds = jax_get_dataset(JaxDataConfig(**_map_kw(tree)), training=False,
                          split_file=tree["val_split"])
    pds = get_dataset(DataConfig(**_map_kw(tree)), training=False, split_file=tree["val_split"])
    with pytest.raises(ValueError, match="at least one array"):
        jds.sample(0, np.random.RandomState(0))
    b = pds.sample(0, np.random.RandomState(0))
    assert "map_mask" not in b and "map_params" not in b and b["mask"].shape == (H, W, 1)


def test_nearest_warp_matches_jax_on_half_ties():
    rng = np.random.RandomState(0)
    b, h, w, c = 2, 6, 9, 3
    img = rng.rand(b, h, w, c).astype(np.float32)
    # exact .5 coordinates (even and odd floors), integers, past the border
    xs = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 3.0, 3.49, 3.51, 7.5, 8.5, 9.5, 12.0], np.float32)
    ys = np.array([-0.5, 0.5, 1.5, 2.5, 4.5, 5.5, 6.5, 2.0, 0.49, 3.5, 1.5, -3.0], np.float32)
    coords = np.stack(np.meshgrid(xs, ys), -1)[None].repeat(b, 0)
    coords = np.concatenate([coords, rng.uniform(-2, 11, (b, 12, 12, 2)).astype(np.float32)], 1)
    want = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(coords), method="nearest"))
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(coords), method="nearest")
    np.testing.assert_array_equal(got.numpy(), want)
    # torch's own nearest mode rounds the ties to even, so it differs there
    grid = torch.from_numpy(coords) * torch.tensor([2 / (w - 1), 2 / (h - 1)]) - 1
    torch_nearest = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), grid,
                                  mode="nearest", padding_mode="border",
                                  align_corners=True).permute(0, 2, 3, 1)
    assert not torch.equal(torch_nearest, got)


@pytest.mark.parametrize("size", [112, 56, 28, 14, 7])
def test_area_resize_to_a_crops_feature_sizes_matches_jax(size):
    """The rotation pretext's feature regularisation resizes the 320x1024
    target to each stage of a 224 crop: non-integer factors, which the
    JAX package resamples with an antialiased linear filter."""
    x = np.random.RandomState(size).rand(2, 320, 1024, 3).astype(np.float32)
    np.testing.assert_allclose(resize_area(torch.from_numpy(x), size, size).numpy(),
                               np.asarray(jax_resize_area(jnp.asarray(x), size, size)),
                               rtol=1e-5, atol=4e-6)


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_rot90_matches_jax(k):
    x = np.random.RandomState(k).rand(3, 5, 5, 2).astype(np.float32)
    want = np.asarray(jnp.rot90(jnp.asarray(x), k, axes=(1, 2)))
    got = aux_nets.rotate_batch(torch.from_numpy(x), torch.full((3,), k))
    np.testing.assert_array_equal(got.numpy(), want)
    nchw = torch.rot90(torch.from_numpy(x).permute(0, 3, 1, 2), k, dims=(2, 3))
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)


def test_rotate_batch_matches_jax_selection():
    x = np.random.RandomState(4).rand(4, 6, 6, 3).astype(np.float32)
    labels = np.array([2, 0, 3, 1])
    want = _jax_rotate_with(jnp.asarray(x), labels)
    got = aux_nets.rotate_batch(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_rotate_with(images, labels):
    """`random_rotate_batch`'s selection with the labels given."""
    rots = jnp.stack([jnp.rot90(images, k, axes=(1, 2)) for k in range(4)], axis=0)
    sel = jax.nn.one_hot(jnp.asarray(labels), 4, dtype=images.dtype)
    return jnp.einsum("kbhwc,bk->bhwc", rots, sel)


def test_batch_softmax_cross_entropy_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 4)
    labels = np.array([0, 3, 1, 1, 2, 0])
    with jax.enable_x64(True):
        want, want_grad = jax.value_and_grad(jax_aux._cross_entropy_with_batch_softmax)(
            jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    got = aux_nets.cross_entropy_with_batch_softmax(t, torch.from_numpy(labels))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-14)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=1e-12, atol=1e-15)


def test_draw_pretext_ranges_and_determinism():
    draws = [aux_nets.draw_pretext(torch.Generator().manual_seed(5), 12, 320, 1024, 224)
             for _ in range(2)]
    assert draws[0][:2] == draws[1][:2] and torch.equal(draws[0][2], draws[1][2])
    g = torch.Generator().manual_seed(0)
    ri, rj, labels = zip(*[aux_nets.draw_pretext(g, 12, 320, 1024, 224) for _ in range(200)])
    assert all(isinstance(v, int) for v in ri + rj)
    assert min(ri) == 0 and max(ri) == 320 - 224
    assert min(rj) >= 0 and max(rj) <= 1024 - 224 and len(set(rj)) > 100
    labels = torch.stack(labels)
    assert labels.dtype == torch.int64 and labels.device.type == "cpu"
    assert set(labels.unique().tolist()) == {0, 1, 2, 3}
    # a square image has one offset, (0, 0)
    assert aux_nets.draw_pretext(g, 2, 32, 32, 32)[:2] == (0, 0)


DRAW_PRETEXT = aux_nets.draw_pretext


def _im_rot_step(remat, monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args)
        return DRAW_PRETEXT(*args)

    monkeypatch.setattr(aux_nets, "draw_pretext", counted)
    kw = dict(pretext_kwargs("mono_fm_joint_im_rot"), remat=remat, depth_dropout_rate=0.5)
    state = create_train_state(ModelConfig(**kw), OptimConfig(warmup_iters=2), 100, seed=3,
                               device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in pretext_inputs(np.float32).items()}
    metrics = make_train_step(state.model, state.optimizer)(
        batch, torch.Generator().manual_seed(0), torch.Generator().manual_seed(1))
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters() if p.grad is not None}
    return metrics, grads, calls


def test_im_rot_remat_draws_once_and_equals_remat_off(monkeypatch):
    off, off_grads, off_calls = _im_rot_step(False, monkeypatch)
    on, on_grads, on_calls = _im_rot_step(True, monkeypatch)
    assert len(off_calls) == len(on_calls) == 1
    assert off_calls[0][1:] == (2, 64, 160, 48)
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    assert set(on_grads) == set(off_grads)
    for n in off_grads:
        assert torch.equal(on_grads[n], off_grads[n]), n
