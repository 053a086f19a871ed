"""The port's host image loader (`tripled_tpu_torch/data/native_loader.py`,
`csrc/loader.cpp`) against the JAX package's (`tripled_tpu/data/
native_loader.py`) and PIL: `load_image` and `load_batch` equal the JAX
loader's float32 arrays bit for bit, and PIL's Lanczos resize after
rounding, over down-, up- and identity scales, flips, PNG and JPEG; a
missing or undecodable file raises IOError, and a batch names how many of
its images failed; the library is built under `build/tripled_tpu_torch/`.

The file skips only where g++, png.h or jpeglib.h is missing.

`steady_jax_native_loader` (also used by `test_torch_port_data_fast.py`):
the JAX package builds its library in place at first use, with no lock
(`tripled_tpu/data/native_loader.py:28-47`), and every pytest-xdist worker
imports `tests/test_native_loader.py`, whose module-level `skipif` calls
`available()`, at once on a checkout without the library: each worker runs
g++ into the same file, and one that loads it while another is writing it
gives up for the rest of its run. On a fresh checkout under six
workers that failed the 25 native cases of `test_torch_port_data_fast.py`
in one run of five. The helper rebuilds the library into a file of its
own, moves it into place and lets the JAX module load it again; it does
nothing where the JAX loader is already loaded.
"""

import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from tripled_tpu.data import native_loader as jax_nl
from tripled_tpu_torch.data import native_loader as nl
from tripled_tpu_torch.utils.cuda_build import BUILD_DIR

torch.set_num_threads(1)

SHAPES = [(32, 96), (64, 192), (96, 320), (128, 480), (50, 128), (375, 1242)]


@pytest.fixture(scope="module", autouse=True)
def _toolchain():
    missing = [what for what, ok in [
        ("g++", shutil.which("g++") is not None),
        ("png.h", os.path.exists("/usr/include/png.h")),
        ("jpeglib.h", os.path.exists("/usr/include/jpeglib.h"))] if not ok]
    if missing:
        pytest.skip(f"the native loader needs {', '.join(missing)}")
    assert nl.available() and steady_jax_native_loader()


def steady_jax_native_loader() -> bool:
    """Load the JAX package's native loader in this process again if its
    first load failed, from a library built atomically; its availability."""
    if jax_nl.available():
        return True
    so = jax_nl._SO
    jax_nl._SO = f"{so}.{os.getpid()}.tmp"  # `_build` writes to `_SO`
    try:
        built = jax_nl._build()
    finally:
        tmp, jax_nl._SO = jax_nl._SO, so
    if built:
        os.replace(tmp, so)
    with jax_nl._lock:
        jax_nl._tried = False
    return jax_nl.available()


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A textured 96x320 PNG, the same frame as a JPEG, and a 375x1242 PNG
    (KITTI's size)."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    y, x = np.mgrid[0:96, 0:320]
    img = np.stack([(x + y) % 255, x % 255, y % 255], -1).astype(np.uint8)
    img = (0.7 * img + 0.3 * rng.rand(96, 320, 3) * 255).astype(np.uint8)
    paths = {"png": str(d / "frame.png"), "jpg": str(d / "frame.jpg"),
             "kitti": str(d / "kitti.png")}
    Image.fromarray(img).save(paths["png"])
    Image.fromarray(img).save(paths["jpg"], quality=95)
    Image.fromarray((rng.rand(375, 1242, 3) * 255).astype(np.uint8)).save(paths["kitti"])
    return paths


def _pil(path, h, w, flip):
    img = Image.open(path).convert("RGB")
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return np.asarray(img.resize((w, h), Image.LANCZOS))


@pytest.mark.parametrize("kind", ["png", "jpg", "kitti"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
def test_load_image_matches_jax_and_pil(images, kind, flip):
    path = images[kind]
    for h, w in SHAPES:
        got = nl.load_image(path, h, w, flip=flip)
        assert got.shape == (h, w, 3) and got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_nl.load_image(path, h, w, flip=flip),
                                      err_msg=f"{kind} {h}x{w}")
        if kind != "jpg":  # libjpeg and PIL's decoder round differently
            np.testing.assert_array_equal(np.rint(got * 255).astype(np.uint8),
                                          _pil(path, h, w, flip), err_msg=f"{kind} {h}x{w}")
        # the loader multiplies by 1/255: the same floats as the JAX loader's,
        # which a divide by 255 would not always give
        np.testing.assert_array_equal(got, np.rint(got * 255).astype(np.float32)
                                      * np.float32(1 / 255))


@pytest.mark.parametrize("num_threads", [1, 3, None])
def test_load_batch_matches_jax(images, num_threads):
    paths = [images["png"], images["kitti"], images["jpg"]] * 2
    flips = [False, True, False, True, True, False]
    got = nl.load_batch(paths, 64, 192, flips=flips, num_threads=num_threads)
    np.testing.assert_array_equal(
        got, jax_nl.load_batch(paths, 64, 192, flips=flips, num_threads=num_threads))
    for i, (p, f) in enumerate(zip(paths, flips)):
        np.testing.assert_array_equal(got[i], nl.load_image(p, 64, 192, flip=f))
    np.testing.assert_array_equal(got[3], got[0][:, ::-1])  # a flip mirrors the resize


def test_failures_raise_with_counts(images, tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 64)  # a PNG signature, no image
    text = tmp_path / "text.png"
    text.write_text("not an image")
    for path in (str(tmp_path / "missing.png"), str(bad), str(text)):
        with pytest.raises(IOError, match="native load failed"):
            nl.load_image(path, 32, 32)
        with pytest.raises(IOError):
            jax_nl.load_image(path, 32, 32)
    paths = [images["png"], str(bad), images["png"], str(tmp_path / "missing.png")]
    for threads in (1, 2):
        with pytest.raises(IOError, match="2/4 images failed"):
            nl.load_batch(paths, 32, 32, num_threads=threads)


def test_library_lands_under_build():
    path = nl.library_path()
    assert path.parent == BUILD_DIR
    assert path.name.startswith("libtripled_loader-") and path.suffix == ".so"
    assert path.exists() and nl.load_library()._name == str(path)
    # nothing is written beside the source
    assert sorted(os.listdir(nl.SOURCES[0].parent)) == sorted(
        f for f in os.listdir(nl.SOURCES[0].parent) if f.endswith((".cu", ".cpp")))
