"""TripleDNet for the mono_fm and mono_baseline presets
(`tripled_tpu/models/net.py`).

Inputs are a dict of stacked tensors in the JAX package's layout, frame axis
F in `cfg.frame_ids` order (index 0 is the target frame):
  color, color_aug  (B, F, H, W, 3) in [0, 1]
  K, inv_K          (B, 4, 4)
In training mode the forward returns (outputs, loss_dict) with scalar
losses; in eval mode, the 4-scale disparity list [s0..s3], each
(B, h, w, 1). The networks run NCHW; the losses take NHWC views, as the
JAX functions they mirror do.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models.depth_decoder import DepthDecoder
from tripled_tpu_torch.models.encoders import DepthEncoder, Extractor, PoseEncoder
from tripled_tpu_torch.models.pose_decoder import PoseDecoder
from tripled_tpu_torch.ops.geometry import (
    disp_to_depth,
    invert_intrinsics,
    scale_intrinsics,
    transformation_from_parameters,
    warp_coords,
)
from tripled_tpu_torch.ops.image import resize_bilinear
from tripled_tpu_torch.ops.losses import perceptional_loss, smooth_loss
from tripled_tpu_torch.ops.photometric import fused_min_reprojection
from tripled_tpu_torch.ops.warp import grid_sample
from tripled_tpu_torch.presets import canonicalize


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class TripleDNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg = canonicalize(cfg)
        self.cfg = cfg
        self.depth_encoder = DepthEncoder(cfg.depth_num_layers)
        self.depth_decoder = DepthDecoder(self.depth_encoder.num_ch_enc,
                                          dropout_rate=cfg.depth_dropout_rate)
        self.pose_encoder = PoseEncoder(cfg.pose_num_layers, 2)
        self.pose_decoder = PoseDecoder(self.pose_encoder.num_ch_enc[-1])
        if cfg.use_extractor:
            self.extractor = Extractor(cfg.extractor_num_layers)
            if cfg.freeze_extractor:
                self.extractor.requires_grad_(False)

    # ------------------------------------------------------------- forward

    def forward(self, inputs: Dict[str, torch.Tensor], generator: torch.Generator | None = None):
        """`generator` draws the decoder's dropout in training."""
        c = self.cfg
        scene = self.depth_encoder(_nchw(inputs["color_aug"][:, 0]))
        disps = [_nhwc(d) for d in self.depth_decoder(scene, generator)]
        if not self.training:
            return disps

        outputs: Dict[str, Any] = {"disps": disps}
        outputs["cam_T_cam"] = self._predict_poses(inputs)

        features = None
        if c.use_extractor:
            features = self._extract(inputs["color"][:, 0])

        return outputs, self._compute_losses(inputs, outputs, features)

    def _extract(self, img):
        """Extractor features (NCHW list). Frozen: no autograd graph is kept,
        but BatchNorm still normalises with batch statistics and updates its
        running statistics, as the JAX step does."""
        if self.cfg.freeze_extractor:
            with torch.no_grad():
                return self.extractor(_nchw(img))
        return self.extractor(_nchw(img))

    # --------------------------------------------------------------- poses

    def _predict_poses(self, inputs):
        """PoseEncoder + PoseDecoder on each (temporally ordered) frame pair
        at the fixed pose resolution."""
        c = self.cfg

        def at_pose_res(x):
            return resize_bilinear(x, c.pose_height, c.pose_width)

        tgt = at_pose_res(inputs["color_aug"][:, 0])
        cam_T_cam = {}
        for i, f_i in enumerate(c.frame_ids[1:], start=1):
            src = at_pose_res(inputs["color_aug"][:, i])
            pair = (src, tgt) if f_i < 0 else (tgt, src)
            feats = self.pose_encoder(_nchw(torch.cat(pair, dim=-1)))
            axisangle, translation = self.pose_decoder(feats[-1])
            cam_T_cam[i] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f_i < 0)
        return cam_T_cam

    # --------------------------------------------------------------- warps

    def _warp_colors(self, inputs, outputs, disp):
        """Backward-warp each source frame into the target view."""
        c = self.cfg
        disp = resize_bilinear(disp, c.height, c.width)
        _, depth = disp_to_depth(disp, c.min_depth, c.max_depth)
        warped = []
        for i in range(1, c.num_frames):
            coords = warp_coords(depth, inputs["inv_K"], inputs["K"], outputs["cam_T_cam"][i])
            warped.append(grid_sample(inputs["color"][:, i], coords))
        return warped

    def _warp_features(self, inputs, outputs, disp0):
        """Warp extractor stage-0 features of each source frame at H/2."""
        c = self.cfg
        disp = resize_bilinear(disp0, c.height // 2, c.width // 2)
        _, depth = disp_to_depth(disp, c.min_depth, c.max_depth)
        K2 = scale_intrinsics(inputs["K"], 0.5, 0.5)
        inv_K2 = invert_intrinsics(K2)
        feats = []
        for i in range(1, c.num_frames):
            coords = warp_coords(depth, inv_K2, K2, outputs["cam_T_cam"][i])
            src_f = _nhwc(self._extract(inputs["color"][:, i])[0])
            feats.append(grid_sample(src_f, coords))
        return feats

    # -------------------------------------------------------------- losses

    def _compute_losses(self, inputs, outputs, features):
        c = self.cfg
        n_scales = len(c.scales)
        target = inputs["color"][:, 0]
        loss_dict: Dict[str, torch.Tensor] = {}

        if features is not None and c.perception_weight > 0:
            tgt_f = _nhwc(features[0])
            warped_feats = self._warp_features(inputs, outputs, outputs["disps"][0])
            percep = [perceptional_loss(tgt_f, sf) for sf in warped_feats]
            min_percep = torch.cat(percep, dim=-1).min(dim=-1).values
            loss_dict["min_perceptional_loss"] = c.perception_weight * min_percep.mean()

        # identity candidates first, so that an exact tie keeps the pixel
        # automasked; they and the target are input frames, so only the
        # warped candidates get a gradient
        idents = [inputs["color"][:, i] for i in range(1, c.num_frames)] if c.automask else []
        n_id = len(idents)
        for s in c.scales:
            disp = outputs["disps"][s]
            warped = self._warp_colors(inputs, outputs, disp)
            preds = torch.stack(idents + warped, dim=1)
            min_rec, _ = fused_min_reprojection(
                target, preds, grad_ks=tuple(range(n_id, preds.shape[1])),
                need_target_grad=False)
            loss_dict[f"min_reconstruct_loss/{s}"] = min_rec.mean() / n_scales

            if c.disp_norm:
                disp = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
            loss_dict[f"smooth_loss/{s}"] = (
                c.smoothness_weight * smooth_loss(disp, target) / (2**s) / n_scales)
        return loss_dict
