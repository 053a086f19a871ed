"""The rotation pretext's draws and loss, and the standalone pretext models
`Autoencoder` (and the masked inpainter) and `RotNet`
(`tripled_tpu/models/aux_nets.py`).

The crop offset and the rotation labels are drawn on the host, from a CPU
`torch.Generator` of their own (`draw_pretext`), not from the dropout's:
the JAX package's `crop` and `rotation` PRNG streams draw bits the port
cannot reproduce, so the tests replace `draw_pretext` (and the JAX
package's `random_crop` and `random_rotate_batch`) with fixed draws. The
draws are a few integers: the card and the CPU see the same values, and
the offsets stay host integers, so cropping needs no device sync. Per
call, in this order: the row offset, the column offset, then one label
per sample.

Kept on purpose, as the JAX package has them: one crop offset for the
whole batch (torchvision's RandomCrop on a batched tensor), a label in
{0, 1, 2, 3} drawn per sample, rot90 over (H, W), and the softmax taken
over the batch before the cross entropy.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models.decoders import ImageDecoder
from tripled_tpu_torch.models.encoders import Extractor
from tripled_tpu_torch.models.layers import flax_init_
from tripled_tpu_torch.ops.image import resize_bilinear
from tripled_tpu_torch.ops.losses import erased_mean, feature_regularization_loss, reprojection_loss
from tripled_tpu_torch.parallel.dist import gather_rows, rank_rows, world_size


def draw_pretext(generator: torch.Generator | None, batch: int, height: int, width: int,
                 size: int):
    """(ri, rj, labels): the batch's crop offset, host integers with
    0 <= ri <= height - size and 0 <= rj <= width - size, and a CPU int64
    tensor of `batch` rotation labels in {0, 1, 2, 3}. The labels are drawn
    for the global batch and each rank keeps its rows
    (`parallel.dist.rank_rows`); the offset is one for all."""
    ri = int(torch.randint(0, height - size + 1, (), generator=generator))
    rj = int(torch.randint(0, width - size + 1, (), generator=generator))
    labels = rank_rows(torch.randint(0, 4, (batch * world_size(),), generator=generator))
    return ri, rj, labels


def crop(x: torch.Tensor, ri: int, rj: int, size: int) -> torch.Tensor:
    """The (size, size) window at (ri, rj) of NHWC x."""
    return x[:, ri:ri + size, rj:rj + size]


def rotate_batch(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sample b of NHWC x (square) rotated by labels[b] * 90 degrees
    counter-clockwise over (H, W), as `jnp.rot90(x, k, axes=(1, 2))`."""
    return torch.stack([torch.rot90(x[b], int(k), dims=(0, 1))
                        for b, k in enumerate(labels.tolist())])


def cross_entropy_with_batch_softmax(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The cross entropy of log_softmax over classes of softmax over the
    *batch* of the logits, averaged over the batch. The batch is the global
    one: with more than one rank, every rank's logits and labels are
    gathered (`parallel.dist.gather_rows`) and each rank computes the whole
    loss."""
    logits = gather_rows(logits)
    labels = gather_rows(labels.to(logits.device))
    logp = torch.log_softmax(torch.softmax(logits, dim=0), dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


class Dense(nn.Linear):
    """nn.Linear starting as flax's Dense: lecun-normal kernel, truncated at
    two standard deviations, and a zero bias."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__(in_features, out_features)
        flax_init_(self)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def feature_smooth_losses(features, target, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """`smooth_loss/{i}`: each stage's feature regularisation against the
    full target, / 2**i / 5."""
    return {f"smooth_loss/{i}": feature_regularization_loss(_nhwc(f), target, cfg.dis, cfg.cvt)
            / (2**i) / 5 for i, f in enumerate(features)}


class Autoencoder(nn.Module):
    """Extractor and ImageDecoder reconstructing the target (`masked`: from
    the erased target, the inpainter), scored by each stage's feature
    regularisation and a 4-scale SSIM + L1 reconstruction, on the erased
    pixels when masked. Eval returns the reconstructions [s0..s3], NHWC.
    With `remat` the encoder's and decoder's activations are recomputed in
    the backward (the JAX module ignores remat; its tree is the same)."""

    def __init__(self, cfg: ModelConfig, masked: bool = False):
        super().__init__()
        self.cfg = cfg
        self.masked = masked
        self.encoder = Extractor(cfg.extractor_num_layers, remat=cfg.remat)
        self.decoder = ImageDecoder(self.encoder.num_ch_enc[4], 3, remat=cfg.remat)

    def forward(self, inputs: Dict[str, torch.Tensor], generator=None, pretext=None,
                automask=None):
        """`generator`, `pretext` and `automask` are unused (the steps'
        signature)."""
        c = self.cfg
        target = inputs["color"][:, 0]
        enc_in = target * inputs["mask"] if self.masked else target
        features = self.encoder(_nchw(enc_in))
        res_imgs = [_nhwc(x) for x in self.decoder(features)]
        if not self.training:
            return res_imgs
        loss_dict = feature_smooth_losses(features, target, c)
        for s in c.scales:
            pred = res_imgs[s]
            h, w = pred.shape[1], pred.shape[2]
            rec = reprojection_loss(pred, resize_bilinear(target, h, w))
            if self.masked:
                rec = erased_mean(rec, resize_bilinear(inputs["mask"], h, w))
            else:
                rec = rec.mean()
            loss_dict[f"min_reconstruct_loss/{s}"] = rec / len(c.scales)
        return {"res_imgs": res_imgs}, loss_dict


class RotNet(nn.Module):
    """Rotation prediction: the extractor on a rotated crop of the target,
    a `pretext_label_size`-way head on its mean-pooled last stage, scored
    by each stage's feature regularisation (against the full target) and
    the batch-softmax cross entropy. It draws its crop and rotations in
    eval too, and then returns {"rot_predicts", "rot_gt"}."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Extractor(cfg.extractor_num_layers, remat=cfg.remat)
        self.head = Dense(self.encoder.num_ch_enc[4], cfg.pretext_label_size)

    def forward(self, inputs: Dict[str, torch.Tensor], generator=None, pretext=None,
                automask=None):
        """`pretext` (a CPU torch.Generator) draws the crop and rotations;
        `generator` and `automask` are unused (the steps' signature)."""
        c = self.cfg
        target = inputs["color"][:, 0]
        b, h, w, _ = target.shape
        ri, rj, labels = draw_pretext(pretext, b, h, w, c.pretext_resize)
        rotated = rotate_batch(crop(target, ri, rj, c.pretext_resize), labels)
        features = self.encoder(_nchw(rotated))
        logits = self.head(features[-1].mean(dim=(2, 3)))
        outputs = {"rot_predicts": logits, "rot_gt": labels}
        if not self.training:
            return outputs
        loss_dict = feature_smooth_losses(features, target, c)
        loss_dict["ssl_rot_loss"] = cross_entropy_with_batch_softmax(logits, labels) * c.pretext_weight
        return outputs, loss_dict
