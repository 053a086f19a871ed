"""Shared blocks (`tripled_tpu/models/layers.py`), NCHW, and the
activation recomputation (`remat`) the encoders and decoders use.

Convolutions outside the ResNets keep PyTorch's default Conv2d init,
U(+-1/sqrt(fan_in)) for kernel and bias, which is what the JAX package's
`torch_conv_kernel` / `torch_conv_bias` reproduce, where the JAX module
asks for them (`Conv1x1`, `Conv3x3`). The attention blocks' plain
`nn.Conv` and `nn.Dense` take flax's default instead, lecun-normal
truncated at two standard deviations and a zero bias (`flax_init_`), and
`UpShuffle` its sub-pixel init: each module's docstring says which.

Dtypes follow flax's promotion: a convolution computes in the wider of
its input's and its parameters' dtypes, so bf16-rounded parameters meeting
a float32 input compute in float32, and float32 parameters meeting a bf16
input too. BatchNorm computes in float32 and returns its input's dtype.
A bf16 convolution followed by BatchNorm hands it its float32 result
unrounded, on every device (`conv_bn`)."""

from __future__ import annotations

import math
import threading
from contextlib import contextmanager, nullcontext

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tripled_tpu_torch.ops.image import upsample2x_nearest
from tripled_tpu_torch.parallel import dist

_state = threading.local()

# std of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: nn.Module) -> nn.Module:
    """flax's default init for a Conv2d or Linear: lecun-normal (fan-in
    variance), truncated at two standard deviations, and a zero bias."""
    fan_in = module.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(module.weight, std=std, a=-2 * std, b=2 * std)
    if module.bias is not None:
        nn.init.zeros_(module.bias)
    return module


@contextmanager
def _tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _WideConv(torch.autograd.Function):
    """A convolution of bf16 `x` and `w` that returns its float32
    accumulation, with the bf16 operands widened to float32 and the
    gradients rounded back to bf16. On the card cuDNN computes it in TF32,
    whose 10-bit mantissa holds the bf16 operands exactly, forward and
    backward; only x and w are kept for the backward, in bf16."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, groups)
        with _tf32():
            return F.conv2d(x.float(), w.float(), None, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conv
        with _tf32():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x.float(), w.float(), None, stride, padding, dilation, False, [0, 0],
                groups, [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return (None if gx is None else gx.to(x.dtype), None if gw is None else gw.to(w.dtype),
                None, None, None, None)


def conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """bn(conv(x)) for a convolution without bias. A bf16 convolution (bf16
    input and parameters, as the training step casts them) hands BatchNorm
    its float32 accumulation unrounded, and BatchNorm's output is rounded
    to bf16 once: so XLA computes the JAX package's convolution and
    BatchNorm, its excess precision (on by default) dropping the round
    trip through bf16 into BatchNorm's float32 arithmetic. The same on
    every device; on the card it costs TF32 convolutions (`_WideConv`)
    where cuDNN's bf16 ones would round their output."""
    if torch.promote_types(x.dtype, conv.weight.dtype) != torch.bfloat16:
        return bn(conv(x))
    y = _WideConv.apply(x, conv.weight, conv.stride, conv.padding, conv.dilation, conv.groups)
    return bn(y).to(torch.bfloat16)


def recomputing() -> bool:
    """True while `remat` recomputes a forward inside the backward."""
    return getattr(_state, "recomputing", False)


@contextmanager
def _recompute_context():
    # the backward may run on another thread (the autograd engine's device
    # thread), so the flag is that thread's own
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = False


def _contexts():
    return nullcontext(), _recompute_context()


def remat(fn, *args, enabled: bool = True):
    """`fn(*args)`; with `enabled`, while autograd records, its activations
    are dropped after the forward and recomputed in the backward
    (`torch.utils.checkpoint`, non-reentrant). The recompute runs with
    `recomputing()` true, so that BatchNorm leaves its running statistics
    alone. `fn` must draw no random numbers from an explicit generator:
    the recompute would draw them anew."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_contexts)


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    return F.pad(x, (p, p, p, p), mode="reflect")


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in the wider of its input's and its
    parameters' dtypes."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode batch normalisation over the batch of every rank.

    Forward: each rank's per-channel count, mean and biased variance
    (`torch.var_mean`, one pass), gathered in one all-reduce and combined
    by Chan's parallel formula, var = sum n_r (var_r + (mean_r - mean)^2) / N.
    Chosen over an all-reduce of the sum and the sum of squares, whose
    E[x^2] - E[x]^2 cancels in float32 where the mean is large against the
    spread, and over a second centred pass, which would read the
    activations twice and all-reduce twice. Backward: one all-reduce of
    sum(dy) and sum(dy * xhat) over every rank's pixels, so that dx is the
    gradient of the ranks' summed losses; the scale's and bias's gradients
    are this rank's own sums (the gradients' all-reduce adds the ranks').
    Arithmetic in `dtype` (float32 at least); returns x's dtype, the batch
    mean and biased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        xc = x.to(dtype)
        var, mean = torch.var_mean(xc, dim=(0, 2, 3), correction=0)
        count = torch.full_like(mean, xc.numel() // xc.shape[1])
        stats = dist.gather_rows(torch.stack([count, mean, var])[None])  # (ranks, 3, C)
        counts, means, variances = stats.unbind(1)
        n = counts.sum(0)
        mean = (counts * means).sum(0) / n
        var = (counts * (variances + (means - mean) ** 2)).sum(0) / n
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.dtype, ctx.count = dtype, n
        ctx.mark_non_differentiable(mean, var)
        shape = (1, -1, 1, 1)
        y = (xc - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        g = gy.to(ctx.dtype)
        xhat = (x.to(ctx.dtype) - mean.view(shape)) * invstd.view(shape)
        sum_dy = g.sum(dim=(0, 2, 3))
        sum_dy_xhat = (g * xhat).sum(dim=(0, 2, 3))
        sums = dist.global_sum(torch.stack([sum_dy, sum_dy_xhat]))
        n = ctx.count.view(shape)
        gx = (weight * invstd).view(shape) * (
            g - sums[0].view(shape) / n - xhat * sums[1].view(shape) / n)
        return gx.to(x.dtype), sum_dy_xhat.to(weight.dtype), sum_dy.to(weight.dtype), None, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d (momentum 0.1, eps 1e-5) whose running variance takes
    the biased batch variance, as flax's BatchNorm does; PyTorch's own
    update uses the unbiased one. The correction is exact algebra on the
    per-channel vectors: no second pass over the activations.

    As flax's: statistics and arithmetic in float32 with the scale and bias
    as given (bf16-rounded under mixed precision), running statistics in
    float32, the output in the input's dtype. In a `remat` recompute it
    normalises with the batch statistics, as the forward did, and leaves the
    running statistics and the batch count alone: the forward moved them.

    In training with more than one rank (`parallel.dist`), the batch
    statistics are those of every rank's batch (`_CrossRankBatchNorm`), as
    the JAX package's BatchNorm reduces over the global batch under a mesh.
    A `remat` recompute reruns that all-reduce; every rank recomputes the
    same blocks in the same order, so the collectives pair up. With one
    rank it is the `F.batch_norm` path, bit for bit."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # float32 at least (float64 stays float64)
        dtype = torch.promote_types(torch.promote_types(x.dtype, self.weight.dtype), torch.float32)
        weight, bias = self.weight.to(dtype), self.bias.to(dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, weight, bias, False,
                                0.0, self.eps)
        if dist.world_size() > 1:
            y, mean, var = _CrossRankBatchNorm.apply(x, weight, bias, self.eps, dtype)
            if not recomputing():
                with torch.no_grad():
                    self.num_batches_tracked.add_(1)
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
                    self.running_var.mul_(1 - m).add_(m * var.to(self.running_var.dtype))
            return y
        if recomputing():
            # throwaway copies take the update: the output is the same, and
            # autograd saves tensors of the same shapes as in the forward,
            # which checkpoint's recompute check compares
            return F.batch_norm(x, self.running_mean.clone(), self.running_var.clone(), weight,
                                bias, True, self.momentum, self.eps)
        self.num_batches_tracked.add_(1)
        old = self.running_var.detach().clone()
        y = F.batch_norm(x, self.running_mean, self.running_var, weight, bias, True,
                         self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        # torch wrote (1-m)*old + m*n/(n-1)*var; keep (1-m)*old + m*var.
        # Through .data: autograd has the buffer recorded as an input of
        # batch_norm (its backward does not read it) and would refuse a
        # version bump when a module runs twice in one step.
        m = self.momentum
        rv = self.running_var.data
        rv.copy_((1 - m) * old + (rv - (1 - m) * old) * ((n - 1) / n))
        return y


class Conv1x1(Conv2d):
    def __init__(self, in_channels: int, out_channels: int, bias: bool = False):
        super().__init__(in_channels, out_channels, 1, bias=bias)


class Conv3x3(nn.Module):
    """Reflection-padded 3x3 convolution with bias."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 3)

    def forward(self, x):
        return self.conv(reflect_pad(x, 1))


class ConvBlock(nn.Module):
    """Conv3x3 + ELU."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv3x3(in_channels, out_channels)

    def forward(self, x):
        return F.elu(self.conv(x))


def max_pool_5x5_same(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 5, stride=1, padding=2)


def _shift25(a: torch.Tensor, h: int, w: int):
    """The 25 (di, dj) translates of an NCHW array padded by 2 on each side,
    di then dj."""
    for di in range(5):
        for dj in range(5):
            yield a[:, :, di:di + h, dj:dj + w]


class _MaxPool5x5EqMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return max_pool_5x5_same(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        y = max_pool_5x5_same(x)  # recomputed, as the JAX backward does
        h, w = x.shape[2], x.shape[3]
        # -inf padding on x never equals a window's max; +inf padding on y
        # never equals a real x
        xp = F.pad(x, (2, 2, 2, 2), value=-math.inf)
        ties = sum((xs == y).to(g.dtype) for xs in _shift25(xp, h, w))
        gp = F.pad(g / ties, (2, 2, 2, 2))
        yp = F.pad(y, (2, 2, 2, 2), value=math.inf)
        acc = torch.zeros_like(x)
        for ys, gs in zip(_shift25(yp, h, w), _shift25(gp, h, w)):
            acc = acc + torch.where(ys == x, gs, torch.zeros_like(gs))
        return acc.to(x.dtype)


def max_pool_5x5_same_eqmask(x: torch.Tensor) -> torch.Tensor:
    """`max_pool_5x5_same` with the JAX package's equality-mask backward
    (`tripled_tpu/models/layers.py:143-207`): each window's gradient,
    divided by the number of positions tied at its max, goes to every one
    of them, summed over the windows in the JAX order. On tie-free windows
    this is the gradient of the max pool; F.max_pool2d's gives a tied
    window's gradient to one position."""
    return _MaxPool5x5EqMask.apply(x)


class CRPBlock(nn.Module):
    """Chained residual pooling: n_stages x (5x5 max pool -> 1x1 conv),
    each stage summed into the input; with `eqmask_pool`, the pools take
    the equality-mask backward."""

    def __init__(self, channels: int, n_stages: int = 4, eqmask_pool: bool = False):
        super().__init__()
        self.convs = nn.ModuleList(Conv1x1(channels, channels) for _ in range(n_stages))
        self.pool = max_pool_5x5_same_eqmask if eqmask_pool else max_pool_5x5_same

    def forward(self, x):
        top = x
        for conv in self.convs:
            top = conv(self.pool(top))
            x = top + x
        return x


def identity_partial(x: torch.Tensor, part_ratio: int = 2, use_right: bool = False) -> torch.Tensor:
    """Channel slice of an NCHW embedding (`tripled_tpu/models/layers.py:298-303`):
    the first C // part_ratio channels, or with `use_right` the rest."""
    c = x.shape[1] // part_ratio
    return x[:, c:] if use_right else x[:, :c]


def flax_conv(cin: int, cout: int, k: int = 1, padding: int = 0) -> Conv2d:
    """A zero-padded k x k convolution with bias, flax's default init."""
    return flax_init_(Conv2d(cin, cout, k, padding=padding))


def flax_linear(cin: int, cout: int) -> nn.Linear:
    """flax's `nn.Dense(use_bias=False)`: its (in, out) kernel is this
    weight transposed."""
    return flax_init_(nn.Linear(cin, cout, bias=False))


class SqueezeAndExcitationBlock(nn.Module):
    """1x1 conv to channels // reduction, ReLU, 1x1 conv back; flax's
    default init."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.conv1 = flax_conv(channels, channels // reduction)
        self.conv2 = flax_conv(channels // reduction, channels)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


def channel_descriptor(x: torch.Tensor):
    """Per-channel spatial (std, mean), each (B, C, 1, 1) (`ChannelDescriptor`)."""
    mean = x.mean(dim=(2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    return var.sqrt(), mean


class AdaptivelyScaledCALayer(nn.Module):
    """ASCA: squeeze-excitation of the channels' std and of their mean,
    fused by a 1x1 conv, ReLU and a third squeeze-excitation, gating x
    through a sigmoid. flax's default init."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.se_std = SqueezeAndExcitationBlock(channels, reduction)
        self.se_mean = SqueezeAndExcitationBlock(channels, reduction)
        self.fuse = flax_conv(2 * channels, channels)
        self.se_fused = SqueezeAndExcitationBlock(channels, reduction)

    def forward(self, x):
        std, mean = channel_descriptor(x)
        fused = torch.cat([self.se_std(std), self.se_mean(mean)], dim=1)
        fused = self.se_fused(F.relu(self.fuse(fused)))
        return x * torch.sigmoid(fused)


class CALayer(nn.Module):
    """Channel attention on the spatial mean; with `pix_att`, pixel
    attention on x itself; with `contrast_aware`, on -mean / std + std.
    flax's default init."""

    def __init__(self, channels: int, reduction: int = 16, contrast_aware: bool = False,
                 pix_att: bool = False):
        super().__init__()
        self.contrast_aware, self.pix_att = contrast_aware, pix_att
        self.conv1 = flax_conv(channels, channels // reduction)
        self.conv2 = flax_conv(channels // reduction, channels)

    def forward(self, x):
        if self.contrast_aware:
            std, mean = channel_descriptor(x)
            y = -mean / std + std
        elif not self.pix_att:
            y = x.mean(dim=(2, 3), keepdim=True)
        else:
            y = x
        return x * torch.sigmoid(self.conv2(F.relu(self.conv1(y))))


class UpShuffle(nn.Module):
    """Reflection-padded 3x3 conv to channels * r * r, pixel shuffle by r,
    ELU. The shuffle's channel order is nn.PixelShuffle's (output channel c,
    offset (i, j) reads input channel c * r * r + i * r + j), which the JAX
    module reproduces in NHWC. Sub-pixel init: one kaiming-normal (fan-in,
    not truncated) kernel for channels outputs, each repeated r * r times in
    a row, so that the shuffle starts as a smooth upsample; the bias is
    PyTorch's default."""

    def __init__(self, in_channels: int, channels: int, upscale: int = 2):
        super().__init__()
        r = self.upscale = upscale
        self.conv = Conv2d(in_channels, channels * r * r, 3)
        sub = torch.empty(channels, in_channels, 3, 3)
        nn.init.normal_(sub, std=math.sqrt(2.0 / (9 * in_channels)))
        with torch.no_grad():
            self.conv.weight.copy_(sub.repeat_interleave(r * r, dim=0))

    def forward(self, x):
        return F.elu(F.pixel_shuffle(self.conv(reflect_pad(x, 1)), self.upscale))


def _upsample_concat(high, lows):
    return torch.cat([upsample2x_nearest(high)] + list(lows), dim=1)


class ChannelAttention(nn.Module):
    """DIFFNet's channel attention: two bias-free linear layers on the
    spatial mean, a sigmoid gate. flax's default init."""

    def __init__(self, channels: int, ratio: int = 16):
        super().__init__()
        self.fc1 = flax_linear(channels, channels // ratio)
        self.fc2 = flax_linear(channels // ratio, channels)

    def forward(self, x):
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return y[:, :, None, None] * x


class FSEModule(nn.Module):
    """HR-Depth's feature squeeze-excitation: the 2x-upsampled `high` and
    the `lows` concatenated (in_channels in all), gated per channel as
    `ChannelAttention` gates (reduction 16), then a 1x1 conv with bias and
    ReLU. flax's default init."""

    def __init__(self, in_channels: int, out_channels: int, reduction: int = 16):
        super().__init__()
        self.attention = ChannelAttention(in_channels, reduction)
        self.conv = flax_conv(in_channels, out_channels)

    def forward(self, high, lows):
        return F.relu(self.conv(self.attention(_upsample_concat(high, lows))))


class AttentionModule(nn.Module):
    """DIFFNet's decoder fusion: the 2x-upsampled `high` and the `lows`
    concatenated (in_channels in all), channel attention, a zero-padded 3x3
    conv with bias, ReLU. flax's default init."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.attention = ChannelAttention(in_channels)
        self.conv = flax_conv(in_channels, out_channels, 3, padding=1)

    def forward(self, high, lows):
        return F.relu(self.conv(self.attention(_upsample_concat(high, lows))))
