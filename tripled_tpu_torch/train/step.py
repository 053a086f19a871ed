"""Train and predict steps (`tripled_tpu/train/step.py:37-105`).

Three generators draw a step's randomness: `generator`, on the model's
device, the depth decoder's dropout masks (l4's, then l3's); `pretext`, a
CPU generator, the rotation pretext's crop offset and labels
(`models/aux_nets.draw_pretext`: row offset, column offset, one label per
sample), once per step, before the extractor runs; `automask`, on the
model's device, the unfused photometric path's N(0, 1) * 1e-5 tie-break
noise on the identity losses, one draw per scale
(`use_pallas_photometric=False` with automask on; the fused path breaks
ties without noise). The JAX step splits its key into `dropout`,
`automask`, `crop` and `rotation` streams; a torch generator's bits are
not comparable with JAX's PRNG. `train/loop.py` seeds the automask
generator from the config's seed + 2, as the JAX package seeds its
automask stream (`tripled_tpu/train/state.py:28`)."""

from __future__ import annotations

import functools
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict

import torch

from tripled_tpu_torch.ops.geometry import disp_to_depth
from tripled_tpu_torch.parallel import dist
from tripled_tpu_torch.train.optim import Adam


@contextmanager
def cast_floating(model: torch.nn.Module, dtype: torch.dtype):
    """Inside the block each floating parameter of `model` reads as its cast
    to `dtype` (`_cast_floating`, `tripled_tpu/train/step.py:20-34`): a
    tensor autograd records, so that the gradient reaches the parameter
    through the cast and comes out in the parameter's dtype. The parameters
    themselves, and the optimizer's state, keep theirs. Run the forward and
    the backward inside: a `remat` recompute in the backward reads the same
    casts."""
    swapped = []
    try:
        for module in model.modules():
            for name, p in list(module._parameters.items()):
                if p is not None and p.is_floating_point():
                    del module._parameters[name]
                    setattr(module, name, p.to(dtype))
                    swapped.append((module, name, p))
        yield
    finally:
        for module, name, p in reversed(swapped):
            delattr(module, name)
            module._parameters[name] = p


def make_train_step(model: torch.nn.Module, optimizer: Adam) -> Callable:
    """step(batch, generator=None, pretext=None, automask=None) -> metrics:
    every loss_dict entry, `loss` (their sum) and `grad_norm` (before
    clipping), as 0-d float32 tensors. With more than one rank
    (`parallel.dist`) the gradients are averaged over the ranks between the
    backward and the update, and the losses returned are the means over the
    ranks: the global batch's. `model` is any preset's module
    (`presets.build_model`). `generator` draws the decoder's dropout,
    `pretext` the rotation pretext's crop and labels, `automask` the
    unfused photometric path's tie-break noise. Under
    `compute_dtype="bfloat16"` the loss sees every floating parameter
    rounded to bf16 (`cast_floating`); gradients, parameters and Adam's
    moments stay float32."""
    bf16 = model.cfg.compute_dtype == "bfloat16"

    def train_step(batch: Dict[str, torch.Tensor], generator: torch.Generator | None = None,
                   pretext: torch.Generator | None = None,
                   automask: torch.Generator | None = None):
        model.train()
        model.zero_grad(set_to_none=True)
        with cast_floating(model, torch.bfloat16) if bf16 else nullcontext():
            # no reference to the outputs past here
            loss_dict = model(batch, generator, pretext, automask)[1]
            total = sum(loss_dict.values())
            total.backward()
        # the global gradient before the clip and the update
        dist.all_reduce_grads(model.parameters())
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in loss_dict.items()}
        metrics["loss"] = total.detach()
        if dist.world_size() > 1:  # the global batch's losses, in one all-reduce
            dtype = functools.reduce(torch.promote_types, (v.dtype for v in metrics.values()))
            values = dist.all_mean(torch.stack([v.to(dtype) for v in metrics.values()]))
            metrics = {k: x.to(v.dtype) for (k, v), x in zip(metrics.items(), values)}
        metrics["grad_norm"] = grad_norm
        return metrics

    return train_step


def make_segmentation_train_step(model: torch.nn.Module, optimizer: Adam) -> Callable:
    """step(batch) -> (metrics, outputs) for a `SegmentationNet`
    (`tripled_tpu/cli/train_segmentation.py:102-119`): the gradient of
    `seg_ce_loss` over {'image' (B, H, W, 3), 'label' (B, H, W)}, the
    BatchNorm statistics moved by the train-mode forward, and one Adam
    update over every parameter (a frozen encoder's gradient counts as
    zero). metrics: `seg_ce_loss` and `grad_norm` (before clipping), 0-d
    tensors; outputs: the train-mode `log_probs`, detached."""

    def train_step(batch: Dict[str, torch.Tensor]):
        model.train()
        model.zero_grad(set_to_none=True)
        outputs, loss_dict = model(batch)
        loss = loss_dict["seg_ce_loss"]
        loss.backward()
        grad_norm = optimizer.step()
        return ({"seg_ce_loss": loss.detach(), "grad_norm": grad_norm},
                {k: v.detach() for k, v in outputs.items()})

    return train_step


def make_predict_fn(model: torch.nn.Module) -> Callable:
    """Eval-mode prediction: images (B, 1, H, W, 3) -> scale-0 scaled
    disparity (B, h, w, 1), whose inverse is the depth. The parameters are
    not cast: under `compute_dtype="bfloat16"` only the depth encoder's
    input is bf16-rounded, and the networks compute in float32, as the JAX
    package's predict does under flax's promotion."""
    cfg = model.cfg

    @torch.no_grad()
    def predict(images: torch.Tensor) -> torch.Tensor:
        model.eval()
        disps = model({"color_aug": images, "color": images})
        scaled, _ = disp_to_depth(disps[0], cfg.min_depth, cfg.max_depth)
        return scaled

    return predict
