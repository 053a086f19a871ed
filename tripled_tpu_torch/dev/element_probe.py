"""The overlapping row-window sum of `dev/element_probe.py`, on the card:
every output row is the sum of three consecutive input rows, read through
(win, W) row windows that start every th rows, the access pattern of the
photometric kernels' SSIM row halo.

    python -m tripled_tpu_torch.dev.element_probe

runs it at the probe's shape on the card, prints the largest error against
the numpy sum and "OK". The kernel is `csrc/element_probe.cu`, built with
nvcc and called through ctypes. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from tripled_tpu_torch.utils import cuda_build

B, R, W = 2, 56, 256  # rows padded so that the last 24-row window fits
TH, WIN = 16, 24      # row stride of the windows and their height
N_TILES = 3           # windows [t*TH, t*TH + WIN); the last is [32, 56)

SOURCES = (Path(__file__).resolve().parents[1] / "csrc" / "element_probe.cu",)

# Launches of the kernel wrapper since the caller last reset it.
launches = {"row_window_sum": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernel, once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("element_probe", SOURCES)
        lib.element_probe_row_window_sum.argtypes = [_P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.element_probe_row_window_sum.restype = _I
        _lib = lib
    return _lib


def _check(x: torch.Tensor, th: int, win: int, n_tiles: int):
    if x.dim() != 3:
        raise ValueError(f"expected x (B, R, W), got {tuple(x.shape)}")
    if th < 1 or n_tiles < 1 or win < th + 2:
        raise ValueError(f"need th >= 1, n_tiles >= 1 and win >= th + 2, got {th}, {win}, {n_tiles}")
    if x.shape[1] < (n_tiles - 1) * th + win:
        raise ValueError(f"{x.shape[1]} rows do not hold {n_tiles} windows of {win} at stride {th}")


def row_window_sum_plain(x: torch.Tensor, th: int = TH, win: int = WIN,
                         n_tiles: int = N_TILES) -> torch.Tensor:
    """(B, R, W) -> (B, n_tiles * th, W): rows r, r+1, r+2 summed in that
    order, the numpy reference of `dev/element_probe.py:52-54`."""
    _check(x, th, win, n_tiles)
    n = n_tiles * th
    return x[:, 0:n] + x[:, 1:n + 1] + x[:, 2:n + 2]


def row_window_kernel(x: torch.Tensor, th: int = TH, win: int = WIN,
                      n_tiles: int = N_TILES) -> torch.Tensor:
    """Launch the kernel on a contiguous float32 CUDA tensor."""
    _check(x, th, win, n_tiles)
    if not x.is_cuda:
        raise ValueError("row_window_kernel takes a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("row_window_kernel takes a contiguous float32 tensor")
    b, r, w = x.shape
    with torch.cuda.device(x.device):
        out = torch.empty((b, n_tiles * th, w), dtype=torch.float32, device=x.device)
        err = load_library().element_probe_row_window_sum(
            x.data_ptr(), out.data_ptr(), b, r, w, th, win, n_tiles,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"element_probe_row_window_sum launch failed: cudaError {err}")
    launches["row_window_sum"] += 1
    return out


def row_window_sum(x: torch.Tensor, th: int = TH, win: int = WIN,
                   n_tiles: int = N_TILES) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return row_window_sum_plain(x, th, win, n_tiles)
    if x.is_cuda:
        return row_window_kernel(x, th, win, n_tiles)
    raise ValueError(f"row_window_sum runs on CPU or CUDA tensors, not {x.device}")


def main(device: str = "cuda") -> float:
    """The probe at its shape; returns the largest error."""
    x_np = np.random.RandomState(0).rand(B, R, W).astype(np.float32)
    out = row_window_sum(torch.from_numpy(x_np).to(device)).cpu().numpy()
    ref = sum(x_np[:, di:di + N_TILES * TH, :] for di in range(3))
    err = float(np.abs(out - ref).max())
    print(f"overlapping row windows: max err {err:.3e}")
    assert err < 1e-6
    print("OK")
    return err


if __name__ == "__main__":
    main()
