"""Fused photometric min-reprojection: the CUDA kernels, their plain
versions, and the autograd binding.

    loss_k = 0.85 * mean_c SSIM_3x3(preds[:, k], target)
             + 0.15 * mean_c robust_l1(preds[:, k], target)
    out, idx = min_k loss_k, argmin_k loss_k   (strict <, first k wins)

The contract is that of `tripled_tpu/ops/pallas/photometric.py:545-598`:
target (B, H, W, C), preds (B, K, H, W, C), float32 or bfloat16 with
float32 arithmetic; out (B, H, W) float32, idx (B, H, W) int32; gradients
in the input dtype, zero for candidates outside `grad_ks`; no target
gradient (None, autograd's zero) when `need_target_grad` is False.

The kernels are `csrc/photometric.cu` (see the note there), built with
nvcc and called through ctypes. A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Sequence

import torch

from tripled_tpu_torch.ops.losses import reprojection_loss
from tripled_tpu_torch.utils import cuda_build

SOURCES = (Path(__file__).resolve().parents[1] / "csrc" / "photometric.cu",)

# Launches of each kernel wrapper since the caller last reset them, and the
# same launches by input dtype ("fwd bfloat16": n)
launches = {"fwd": 0, "bwd": 0}
launches_by_dtype: dict[str, int] = {}


def _count(kernel: str, dtype: torch.dtype) -> None:
    launches[kernel] += 1
    key = f"{kernel} {str(dtype).split('.')[-1]}"
    launches_by_dtype[key] = launches_by_dtype.get(key, 0) + 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels, with every argtype set;
    the library is loaded once per process."""
    global _lib
    if _lib is None:
        lib = cuda_build.load("photometric", SOURCES)
        lib.photometric_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.photometric_fwd.restype = _I
        lib.photometric_bwd.argtypes = [_P, _P, _P, _P, _P, _P,
                                        _I, _I, _I, _I, _I, _I, _I, _P]
        lib.photometric_bwd.restype = _I
        lib.photometric_fwd_smem.argtypes = [_I]
        lib.photometric_fwd_smem.restype = _I
        lib.photometric_bwd_smem.argtypes = [_I, _I, _I, _I]
        lib.photometric_bwd_smem.restype = _I
        _lib = lib
    return _lib


# ------------------------------------------------------------ plain versions


def min_reprojection_plain(target: torch.Tensor, preds: torch.Tensor):
    """The K `reprojection_loss` maps in float32 (float64 inputs stay
    float64), their min and first-wins argmin. Differentiable through the
    selected candidate."""
    dtype = torch.promote_types(target.dtype, torch.float32)
    t = target.to(dtype)
    losses = [reprojection_loss(preds[:, k].to(dtype), t)[..., 0] for k in range(preds.shape[1])]
    best = losses[0]
    idx = torch.zeros(best.shape, dtype=torch.int64, device=best.device)
    for k in range(1, len(losses)):
        take = losses[k].detach() < best.detach()
        best = torch.where(take, losses[k], best)
        idx = torch.where(take, torch.full_like(idx, k), idx)
    return best, idx.to(torch.int32)


def min_reprojection_plain_backward(target, preds, g, grad_ks, need_target_grad):
    """Autograd through `min_reprojection_plain`, then zeros for the pruned
    candidates; the target's gradient is None unless needed."""
    with torch.enable_grad():
        t = target.detach().requires_grad_()
        p = preds.detach().requires_grad_()
        out, _ = min_reprojection_plain(t, p)
        dt, dp = torch.autograd.grad(out, (t, p), g)
    keep = torch.zeros(preds.shape[1], dtype=torch.bool, device=preds.device)
    keep[list(grad_ks)] = True
    dp = dp * keep.view(1, -1, 1, 1, 1).to(dp.dtype)
    return (dt if need_target_grad else None), dp


# ------------------------------------------------------------ kernel wrappers


def _check(target, preds):
    if target.device != preds.device or target.dtype != preds.dtype:
        raise ValueError("target and preds must share device and dtype")
    if target.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"photometric kernels take float32 or bfloat16, got {target.dtype}")
    if target.dim() != 4 or preds.dim() != 5:
        raise ValueError("expected target (B, H, W, C) and preds (B, K, H, W, C)")
    B, K, H, W, C = preds.shape
    if tuple(target.shape) != (B, H, W, C):
        raise ValueError(f"target {tuple(target.shape)} does not match preds {tuple(preds.shape)}")
    if H < 2 or W < 2 or not 1 <= K <= 31 or C < 1:
        raise ValueError(f"unsupported shape {tuple(preds.shape)}: need H, W >= 2, 1 <= K <= 31")
    if not (target.is_contiguous() and preds.is_contiguous()):
        raise ValueError("photometric kernels need contiguous inputs")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fwd_kernel(target: torch.Tensor, preds: torch.Tensor):
    """Launch the forward kernel on CUDA tensors."""
    _check(target, preds)
    if not target.is_cuda:
        raise ValueError("fwd_kernel takes CUDA tensors")
    B, K, H, W, C = preds.shape
    with torch.cuda.device(target.device):
        out = torch.empty((B, H, W), dtype=torch.float32, device=target.device)
        idx = torch.empty((B, H, W), dtype=torch.int32, device=target.device)
        err = load_library().photometric_fwd(
            target.data_ptr(), preds.data_ptr(), out.data_ptr(), idx.data_ptr(),
            B, K, H, W, C, int(target.dtype == torch.bfloat16), _stream(target))
    if err != 0:
        raise RuntimeError(f"photometric_fwd launch failed: cudaError {err}")
    _count("fwd", target.dtype)
    return out, idx


def bwd_kernel(target, preds, g, idx, grad_ks: Sequence[int], need_target_grad: bool):
    """Launch the backward kernel (one launch, no scratch) on CUDA tensors.
    Returns (dt, dp) in the input dtype; dt is None unless
    `need_target_grad`."""
    _check(target, preds)
    if not target.is_cuda:
        raise ValueError("bwd_kernel takes CUDA tensors")
    B, K, H, W, C = preds.shape
    if tuple(g.shape) != (B, H, W) or tuple(idx.shape) != (B, H, W):
        raise ValueError("g and idx must be (B, H, W)")
    if g.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError("g must be float32 and idx int32")
    if not (g.is_contiguous() and idx.is_contiguous()):
        raise ValueError("g and idx must be contiguous")
    if g.device != target.device or idx.device != target.device:
        raise ValueError("g and idx must lie on the inputs' device")
    mask = 0
    for k in grad_ks:
        if not 0 <= k < K:
            raise ValueError(f"grad_ks entry {k} outside [0, {K})")
        mask |= 1 << k
    with torch.cuda.device(target.device):
        dp = torch.empty_like(preds)
        dt = torch.empty_like(target) if need_target_grad else None
        err = load_library().photometric_bwd(
            target.data_ptr(), preds.data_ptr(), g.data_ptr(), idx.data_ptr(),
            dp.data_ptr(), dt.data_ptr() if dt is not None else None,
            B, K, H, W, C, mask, int(target.dtype == torch.bfloat16), _stream(target))
    if err != 0:
        raise RuntimeError(f"photometric_bwd launch failed: cudaError {err}")
    _count("bwd", target.dtype)
    return dt, dp


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"photometric ops run on CPU or CUDA tensors, not {t.device}")


class _FusedMinReprojection(torch.autograd.Function):
    @staticmethod
    def forward(ctx, target, preds, grad_ks, need_target_grad):
        target = target.contiguous()
        preds = preds.contiguous()
        if _on_cpu(target):
            with torch.no_grad():
                out, idx = min_reprojection_plain(target, preds)
        else:
            out, idx = fwd_kernel(target, preds)
        ctx.save_for_backward(target, preds, idx)
        ctx.grad_ks = grad_ks
        ctx.need_target_grad = need_target_grad
        ctx.mark_non_differentiable(idx)
        return out, idx

    @staticmethod
    def backward(ctx, g, _g_idx):
        target, preds, idx = ctx.saved_tensors
        if _on_cpu(target):
            dt, dp = min_reprojection_plain_backward(
                target, preds, g, ctx.grad_ks, ctx.need_target_grad)
        else:
            dt, dp = bwd_kernel(target, preds, g.float().contiguous(), idx, ctx.grad_ks,
                                ctx.need_target_grad)
        return dt, dp, None, None


def fused_min_reprojection(target: torch.Tensor, preds: torch.Tensor,
                           grad_ks: Sequence[int] | None = None,
                           need_target_grad: bool = True):
    """min_k reprojection_loss(preds[:, k], target) and its argmin.

    Args:
      target: (B, H, W, C); preds: (B, K, H, W, C).
      grad_ks: candidates whose gradient is consumed (None = all); the
        others get a zero gradient.
      need_target_grad: False gives the target no gradient (None).
    Returns:
      (min_loss (B, H, W) float32, argmin (B, H, W) int32).
    """
    if grad_ks is None:
        grad_ks = tuple(range(preds.shape[1]))
    return _FusedMinReprojection.apply(target, preds, tuple(grad_ks), need_target_grad)
