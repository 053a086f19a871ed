"""TripleDNet for the mono_baseline, mono_fm and mono_fm_joint* presets
(`tripled_tpu/models/net.py`), the flagship
mono_fm_joint_inpaint_disentangle and the five distillation presets
included: the grayscale and ab-colorization heads on the full-resolution
disparity (and its surface normal), and the separate colorize and inpaint
encoder-decoder pairs. Also the three pretext presets: the rotation
pretext (`im_rot`: the extractor on a rotated crop, `rot_head`, and the
perceptual term on crops), map-pose (the pose net on motion-masked,
alpha-mixed frames, and `pose_map_cls` classifying the alpha pair) and
equivariant (the extractor's source features warped into the target
decode each source frame outside its warped erase mask). And every
architecture option: the attention (`ca`, `pa`, `asca`) and 1x1 depth
skips, the 1x1 colour skips, pose from prediction (`use_pfp`), the
pixel-shuffle CRP decoder, HR-Depth's decoder, and DIFFNet (an HRNet
encoder on the raw image with its attention decoder). And the warp and
kernel options: every warp goes through `_grid_sample` (the block warp,
bf16 texels, `warp_align_corners=False`); the unfused photometric path
(`use_pallas_photometric=False`); the eq-mask CRP pool; and the stereo
frame "s", warped by `stereo_T` with no pose.

Inputs are a dict of stacked tensors in the JAX package's layout, frame axis
F in `cfg.frame_ids` order (index 0 is the target frame):
  color, color_aug  (B, F, H, W, 3) in [0, 1], or uint8 (divided by 255
                    here, DataConfig.ship_uint8)
  jitter_params     (B, 9) in place of color_aug in training
                    (DataConfig.device_color_aug): color_aug is made here
                    from color (`ops/jitter.py`)
  K, inv_K          (B, 4, 4)
  mask              (B, H, W, 1) inpaint erase mask, 1 = keep (inpaint only)
  map_mask          (B, F-1, H, W, 1) motion masks (map-pose only)
  map_params        (B, F-1, 3) (label, alpha1, alpha2) per source frame
  stereo_T          (B, 4, 4) when "s" is in frame_ids
In training mode the forward returns (outputs, loss_dict) with scalar
losses; in eval mode, the 4-scale disparity list [s0..s3], each
(B, h, w, 1). The networks run NCHW; the losses take NHWC views, as the
JAX functions they mirror do.

Mixed precision (`compute_dtype="bfloat16"`) casts where the JAX package
casts (`tripled_tpu/models/net.py` `_cd`/`_f32`) and nowhere else: the
depth encoder's and the extractor's target input, the colour decoder's
disparities, the feature-loss operands and the photometric slabs go to
bf16; disparities, decoded images and features come back as float32.
Networks fed float32 (the pose networks, the extractor on the source
frames, the distillation heads and the separate encoders and decoders)
compute in float32 on the bf16-rounded parameters, as flax promotes
(`models/layers.py`). The parameters are cast by the training
step (`train/step.py`); eval-mode prediction keeps them float32.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from tripled_tpu_torch.config import ModelConfig
from tripled_tpu_torch.models import aux_nets
from tripled_tpu_torch.models.aux_nets import Dense, crop, cross_entropy_with_batch_softmax, rotate_batch
from tripled_tpu_torch.models.decoders import ColorDecoder, ImageDecoder
from tripled_tpu_torch.models.depth_decoder import DepthDecoder
from tripled_tpu_torch.models.encoders import DepthEncoder, Extractor, PoseEncoder
from tripled_tpu_torch.models.hr_decoders import DIFFDepthDecoder, HRDepthDecoder
from tripled_tpu_torch.models.hrnet import HRNetFeatures
from tripled_tpu_torch.models.layers import (
    AdaptivelyScaledCALayer,
    BatchNorm,
    CALayer,
    Conv1x1,
    Conv2d,
    flax_init_,
    identity_partial,
)
from tripled_tpu_torch.models.pose_decoder import PoseDecoder
from tripled_tpu_torch.models.resnet import BasicBlock
from tripled_tpu_torch.ops.color import rgb2lab, rgb_to_gray, rgb_to_l
from tripled_tpu_torch.ops.geometry import (
    disp_to_depth,
    invert_intrinsics,
    scale_intrinsics,
    transformation_from_parameters,
    warp_coords,
)
from tripled_tpu_torch.ops.image import resize_bilinear
from tripled_tpu_torch.ops.jitter import color_jitter
from tripled_tpu_torch.ops.losses import (
    erased_mean,
    feature_regularization_loss,
    min_reprojection_with_automask,
    perceptional_loss,
    reprojection_loss,
    smooth_loss,
)
from tripled_tpu_torch.ops.photometric import fused_min_reprojection
from tripled_tpu_torch.ops.warp import grid_sample, grid_sample_block
from tripled_tpu_torch.parallel.dist import global_min, global_sum, rank_rows, world_size
from tripled_tpu_torch.presets import canonicalize


# a warp of at most this many channels is a colour warp, which takes the
# block warp in cfg.warp_block_shape; a wider one (the 64-channel features)
# takes it only under cfg.warp_block_features, in (2, 2) blocks
_COLOR_WARP_MAX_CH = 4


def frames_to_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> float32 in [0, 1], divided by 255 as the JAX package
    and the host path's numpy divide. The divisor is a tensor on x's device:
    CUDA turns a divide by a Python number into a multiply by its
    reciprocal, which rounds 126 of the 256 quotients the other way."""
    x = x.to(torch.float32)
    return x / x.new_full((), 255.0)


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class DistillHead(nn.Module):
    """BasicBlock(in -> 32) and a 1x1 conv with bias, the grayscale and
    colorize distillation heads (`tripled_tpu/models/net.py:109-120`).
    flax infers the input width; here it is given. The 1x1 conv starts as
    flax's default: lecun-normal, truncated at two standard deviations,
    and a zero bias."""

    def __init__(self, in_channels: int, out_channels: int, use_residual: bool):
        super().__init__()
        self.block = BasicBlock(in_channels, 32, use_residual=use_residual)
        self.conv = flax_init_(Conv2d(32, out_channels, 1))

    def forward(self, x):
        """NHWC in and out."""
        return _nhwc(self.conv(self.block(_nchw(x))))


class SkipSplit(nn.Module):
    """One skip layer between an encoder stage and a decoder
    (`tripled_tpu/models/net.py:79-106`): optional attention ("ca", "pa",
    "asca"), then the depth half of a disentangled stage (`split`: the left
    channel half, "use_half", or "1x1", a 1x1 conv to half the channels,
    BatchNorm and ELU), or with `full_1x1` the same 1x1 block at full
    width. Without any of these it passes the stage as it is."""

    def __init__(self, channels: int, attention: str | None = None, split: str | None = None,
                 full_1x1: bool = False):
        super().__init__()
        self.split = split
        self.attention = None
        if attention in ("ca", "pa"):
            self.attention = CALayer(channels, pix_att=attention == "pa")
        elif attention == "asca":
            self.attention = AdaptivelyScaledCALayer(channels)
        if split == "1x1" or (split is None and full_1x1):
            out = channels // 2 if split == "1x1" else channels
            self.conv, self.bn = Conv1x1(channels, out), BatchNorm(out)

    def forward(self, x):
        if self.attention is not None:
            x = self.attention(x)
        if self.split == "use_half":
            return identity_partial(x)
        if hasattr(self, "conv"):
            return F.elu(self.bn(self.conv(x)))
        return x


def _skip_list(owner: nn.Module, name: str, skips: list) -> list:
    """`skips`, registered on `owner` as the ModuleList `name` only where one
    of them holds variables: the JAX model has entries `name_i` only then."""
    if any(True for skip in skips for _ in skip.parameters()):
        setattr(owner, name, nn.ModuleList(skips))
    return skips


class TripleDNet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        cfg = canonicalize(cfg)
        self.cfg = cfg
        disentangled = any(cfg.disentangle_layers)
        if cfg.use_diffnet and disentangled:
            # as the JAX package: its disentangle forward would index the
            # five flat skips into HRNet's nested features
            raise ValueError("use_diffnet cannot be combined with disentangle")
        if cfg.use_diffnet:
            # HRNet of width depth_num_layers on the raw image; no skips
            self.depth_encoder = HRNetFeatures(cfg.depth_num_layers)
            enc_ch = self.depth_encoder.num_ch_enc
            self.depth_decoder = DIFFDepthDecoder(enc_ch)
        else:
            self.depth_encoder = DepthEncoder(cfg.depth_num_layers, remat=cfg.remat)
            enc_ch = self.depth_encoder.num_ch_enc
            # per stage: attention, then a disentangled stage's depth half;
            # an undivided last stage takes the full 1x1 block under
            # depth_skip_type="1x1"
            att = cfg.depth_skip_type if cfg.depth_skip_type in ("ca", "pa", "asca") else None
            last = len(cfg.disentangle_layers) - 1
            self._depth_skips = _skip_list(self, "depth_skips", [
                SkipSplit(ch, att, cfg.depth_disentangle_type) if flag else
                SkipSplit(ch, att, full_1x1=cfg.depth_skip_type == "1x1" and i == last)
                for i, (ch, flag) in enumerate(zip(enc_ch, cfg.disentangle_layers))])
            depth_ch = [ch // 2 if flag else ch
                        for ch, flag in zip(enc_ch, cfg.disentangle_layers)]
            if cfg.use_hr_depth:
                self.depth_decoder = HRDepthDecoder(depth_ch)
            else:
                self.depth_decoder = DepthDecoder(depth_ch, dropout_rate=cfg.depth_dropout_rate,
                                                  remat=cfg.remat,
                                                  use_shuffle=cfg.depth_use_shuffle,
                                                  eqmask_pool=cfg.pool_eqmask_grad)
        self.pose_encoder = PoseEncoder(cfg.pose_num_layers, 2, remat=cfg.remat)
        self.pose_decoder = PoseDecoder(self.pose_encoder.num_ch_enc[-1])
        if cfg.use_extractor:
            self.extractor = Extractor(cfg.extractor_num_layers, remat=cfg.remat)
            if cfg.freeze_extractor:
                self.extractor.requires_grad_(False)
        if cfg.use_image_decoder:
            self.image_decoder = ImageDecoder(self.extractor.num_ch_enc[4], 3, remat=cfg.remat)
        # the colour decoder also exists for pose from prediction
        if disentangled and (cfg.auto_res_weight > 0 or cfg.use_pfp):
            if cfg.color_skip_type == "1x1":
                # whole stages; those of color_skip_layers (stages 0-3)
                # through the 1x1 block to half their channels
                flags = tuple(cfg.color_skip_layers) + (False,)
                self._color_skips = _skip_list(self, "color_skips", [
                    SkipSplit(ch, split="1x1" if flag else None)
                    for ch, flag in zip(enc_ch, flags)])
                color_ch = [ch // 2 if flag else ch for ch, flag in zip(enc_ch, flags)]
            else:  # the right half of each disentangled stage
                color_ch = [ch - ch // 2 if flag else ch
                            for ch, flag in zip(enc_ch, cfg.disentangle_layers)]
            self.color_decoder = ColorDecoder(
                color_ch, 3, skip_connection_multiplier=cfg.skip_connection_multiplier,
                skip_layers=cfg.color_skip_layers, remat=cfg.remat)
        # the heads see the disparity (with use_normal its surface normal's
        # first two channels), the colorize head also Lab L
        if cfg.d2g_weight > 0:
            self.depth_to_gray = DistillHead(2 if cfg.use_normal else 1, 1,
                                             use_residual=not cfg.use_normal)
        if cfg.colorize_weight > 0 and not cfg.sep_colorize:
            self.colorize_net = DistillHead(4 if cfg.use_normal else 2, 2, use_residual=False)
        # the separate encoders are never rematerialised, their decoders are
        # as the other decoders (`tripled_tpu/models/net.py:230-240`)
        if cfg.sep_colorize:
            self.colorize_encoder = Extractor(cfg.colorize_num_layers)
            self.colorize_decoder = ColorDecoder(
                self.colorize_encoder.num_ch_enc, 2,
                skip_connection_multiplier=cfg.skip_connection_multiplier, remat=cfg.remat)
        if cfg.sep_inpaint:
            self.inpaint_encoder = Extractor(cfg.inpaint_num_layers)
            self.inpaint_decoder = ColorDecoder(
                self.inpaint_encoder.num_ch_enc, 3,
                skip_connection_multiplier=cfg.skip_connection_multiplier, remat=cfg.remat)
        if cfg.map_pose:
            self.pose_map_cls = Dense(self.pose_encoder.num_ch_enc[4], cfg.map_output)
        if cfg.im_rot:
            self.rot_head = Dense(self.extractor.num_ch_enc[4], cfg.pretext_label_size)

    # ----------------------------------------------------------- precision

    def _cd(self, x):
        """x (a tensor or a list) in the compute dtype."""
        if self.cfg.compute_dtype != "bfloat16":
            return x
        if isinstance(x, list):
            return [self._cd(t) for t in x]
        return x.to(torch.bfloat16) if x.is_floating_point() else x

    def _f32(self, x):
        """x (a tensor or a list) with bf16 back in float32."""
        if isinstance(x, list):
            return [self._f32(t) for t in x]
        return x.float() if x.dtype == torch.bfloat16 else x

    # ------------------------------------------------------------- forward

    def forward(self, inputs: Dict[str, torch.Tensor], generator: torch.Generator | None = None,
                pretext: torch.Generator | None = None, automask: torch.Generator | None = None):
        """`generator` draws the decoder's dropout in training; `pretext`, a
        CPU generator, the rotation pretext's crop and labels
        (`aux_nets.draw_pretext`); `automask`, on the model's device, the
        unfused photometric path's tie-break noise."""
        c = self.cfg
        inputs = dict(inputs)
        for key in ("color", "color_aug"):
            if key in inputs and inputs[key].dtype == torch.uint8:
                inputs[key] = frames_to_float(inputs[key])
        if self.training and "jitter_params" in inputs:
            inputs["color_aug"] = color_jitter(inputs["color"], inputs["jitter_params"])
        scene = self.depth_encoder(_nchw(self._cd(inputs["color_aug"][:, 0])))
        if c.use_diffnet:  # HRNet's nested features go to the decoder as they are
            depth_emb = scene
        else:
            depth_emb = [skip(f) for skip, f in zip(self._depth_skips, scene)]
        disps_nchw = self._f32(self.depth_decoder(depth_emb, generator))
        disps = [_nhwc(d) for d in disps_nchw]
        if not self.training:
            return disps

        outputs: Dict[str, Any] = {"disps": disps}
        if hasattr(self, "color_decoder"):
            if hasattr(self, "_color_skips"):
                color_emb = [skip(f) for skip, f in zip(self._color_skips, scene)]
            else:
                color_emb = [identity_partial(f, use_right=True) if flag else f
                             for f, flag in zip(scene, c.disentangle_layers)]
            outputs["auto_res"] = [_nhwc(x) for x in self._f32(
                self.color_decoder(color_emb, self._cd(disps_nchw)))]
        # pose from prediction: the reconstructed target, at the pose size,
        # stands for the target frame; the pose loss reaches the colour
        # decoder through it
        pose_target = None
        if c.use_pfp and "auto_res" in outputs:
            pose_target = resize_bilinear(outputs["auto_res"][0], c.pose_height, c.pose_width)
        outputs["cam_T_cam"], outputs["map_logits"] = self._predict_poses(inputs, pose_target)

        features = None
        if c.im_rot:
            # the extractor sees a rotated crop of the target; its features
            # also feed the feature regularisation
            target = inputs["color"][:, 0]
            b, h, w, _ = target.shape
            ri, rj, labels = aux_nets.draw_pretext(pretext, b, h, w, c.pretext_resize)
            rotated = rotate_batch(crop(target, ri, rj, c.pretext_resize), labels)
            features = self._f32(self._extract(self._cd(rotated)))
            outputs["rot_predicts"] = self.rot_head(features[-1].mean(dim=(2, 3)))
            outputs["rot_gt"] = labels
            outputs["crop_offset"] = (ri, rj)
        elif c.use_extractor:
            # only the base inpaint preset masks the extractor's input; the
            # disentangle one feeds it the whole target
            # (`tripled_tpu/models/net.py:367-375`)
            ext_in = inputs["color"][:, 0]
            if c.inpaint and "disentangle" not in c.name and "mask" in inputs:
                ext_in = ext_in * inputs["mask"]
            features = self._extract(self._cd(ext_in))
            if c.use_image_decoder and c.img_reconstruct_weight != 0:
                outputs["res_imgs"] = [_nhwc(x) for x in self._f32(self.image_decoder(features))]
            features = self._f32(features)

        # the separate encoder-decoder pairs, fed float32 and not cast; the
        # depth embedding conditions their encoders under cond_encoder
        cond = depth_emb if c.cond_encoder else None
        if c.sep_colorize:
            lab = rgb2lab(inputs["color"][:, 0])
            gray = lab[..., 0:1].expand(*lab.shape[:3], 3)  # L in [-1, 1], unnormalised
            emb = self.colorize_encoder(_nchw(gray), cond_features=cond)
            outputs["sep_colorize"] = [_nhwc(x) for x in self.colorize_decoder(emb, disps_nchw)]
            outputs["gt_ab"] = lab[..., 1:]
        if c.sep_inpaint:
            emb = self.inpaint_encoder(_nchw(inputs["color"][:, 0] * inputs["mask"]),
                                       cond_features=cond)
            outputs["sep_inpaint"] = [_nhwc(x) for x in self.inpaint_decoder(emb, disps_nchw)]

        return outputs, self._compute_losses(inputs, outputs, features, automask)

    def _extract(self, img, stages: int = 5):
        """Extractor features (NCHW list). Frozen: no autograd graph is kept,
        but BatchNorm still normalises with batch statistics and updates its
        running statistics, as the JAX step does. Stages past the first
        `stages` run in full for those statistics, without a graph."""
        if self.cfg.freeze_extractor:
            with torch.no_grad():
                return self.extractor(_nchw(img))
        return self.extractor(_nchw(img), graph_stages=stages)

    # --------------------------------------------------------------- poses

    def predict_pose(self, img_pair):
        """Pose inference for odometry evaluation (the JAX package's
        `TripleDNet.predict_pose` with train=False): `img_pair` is the
        channel-concatenated (cur, next) frames (B, H, W, 6); returns
        (axisangle, translation), each (B, 1, 1, 3). The pose encoder and
        decoder run in eval mode, BatchNorm on its running statistics, and
        every module is left in the mode it was in."""
        modules = [m for net in (self.pose_encoder, self.pose_decoder) for m in net.modules()]
        modes = [m.training for m in modules]
        try:
            for m in modules:
                m.training = False
            feats = self.pose_encoder(_nchw(img_pair))
            return self.pose_decoder(feats[-1])
        finally:
            for m, mode in zip(modules, modes):
                m.training = mode

    def _predict_poses(self, inputs, target=None):
        """PoseEncoder + PoseDecoder on each (temporally ordered) frame pair
        at the fixed pose resolution, with `target` (NHWC, at that size) in
        place of the target frame where given. Map-pose mixes each source by
        alpha1 and the target by alpha2 inside the source's motion mask,
        and classifies the pose bottleneck's mean. Returns (cam_T_cam,
        map_logits), each by source frame index."""
        c = self.cfg

        def at_pose_res(x):
            return resize_bilinear(x, c.pose_height, c.pose_width)

        tgt = at_pose_res(inputs["color_aug"][:, 0]) if target is None else target
        cam_T_cam, map_logits = {}, {}
        for i, f_i in enumerate(c.frame_ids[1:], start=1):
            if f_i == "s":  # the stereo pair's pose is stereo_T, not predicted
                continue
            src = at_pose_res(inputs["color_aug"][:, i])
            tgt_i = tgt
            if c.map_pose:
                mm = at_pose_res(inputs["map_mask"][:, i - 1])
                mp = inputs["map_params"][:, i - 1]
                a1 = mp[:, 1].reshape(-1, 1, 1, 1)
                a2 = mp[:, 2].reshape(-1, 1, 1, 1) if mp.shape[1] > 2 else a1
                src = src * mm * a1 + src * (1 - mm)
                tgt_i = tgt * mm * a2 + tgt * (1 - mm)
            pair = (src, tgt_i) if f_i < 0 else (tgt_i, src)
            feats = self.pose_encoder(_nchw(torch.cat(pair, dim=-1)))
            axisangle, translation = self.pose_decoder(feats[-1])
            cam_T_cam[i] = transformation_from_parameters(
                axisangle[:, 0], translation[:, 0], invert=f_i < 0)
            if c.map_pose:
                map_logits[i] = self.pose_map_cls(feats[-1].mean(dim=(2, 3)))
        return cam_T_cam, map_logits

    # --------------------------------------------------------------- warps

    def _frame_T(self, inputs, outputs, i):
        """The target-to-source transform of source frame i: `stereo_T` for
        the stereo frame, the predicted pose otherwise."""
        if self.cfg.frame_ids[i] == "s":
            return inputs["stereo_T"]
        return outputs["cam_T_cam"][i]

    def _grid_sample(self, img, coords, method="bilinear"):
        """Every warp of the model (`tripled_tpu/models/net.py:461-504`):
        with warp_align_corners=False the coordinates move to
        x * w/(w-1) - 0.5 and y * h/(h-1) - 0.5, h and w the sampled
        image's; the texels round to warp_gather_dtype; under
        warp_block_gather a bilinear warp of at most _COLOR_WARP_MAX_CH
        channels takes the block warp in warp_block_shape, and one of at
        most 64 under warp_block_features in (2, 2), where the output's
        height and width divide by the block, the exact warp otherwise."""
        c = self.cfg
        if not c.warp_align_corners:
            h, w = img.shape[1], img.shape[2]
            scale = torch.tensor([w / (w - 1.0), h / (h - 1.0)], dtype=coords.dtype,
                                 device=coords.device)
            coords = coords * scale - 0.5
        gd = torch.bfloat16 if c.warp_gather_dtype == "bfloat16" else None
        ch = img.shape[-1]
        if c.warp_block_gather and method == "bilinear" and (
                ch <= _COLOR_WARP_MAX_CH or (c.warp_block_features and ch <= 64)):
            bh, bw = c.warp_block_shape if ch <= _COLOR_WARP_MAX_CH else (2, 2)
            if coords.shape[1] % bh == 0 and coords.shape[2] % bw == 0:
                return grid_sample_block(img, coords, gather_dtype=gd, block=(bh, bw))
        return grid_sample(img, coords, method=method, gather_dtype=gd)

    def _warp_colors(self, inputs, outputs, disp):
        """Backward-warp each source frame into the target view."""
        c = self.cfg
        disp = resize_bilinear(disp, c.height, c.width)
        _, depth = disp_to_depth(disp, c.min_depth, c.max_depth)
        warped = []
        for i in range(1, c.num_frames):
            coords = warp_coords(depth, inputs["inv_K"], inputs["K"],
                                 self._frame_T(inputs, outputs, i))
            warped.append(self._grid_sample(inputs["color"][:, i], coords))
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
            coords = warp_coords(depth, inv_K2, K2, self._frame_T(inputs, outputs, i))
            # only stage 0 reaches the loss; the float32 frame computes in
            # float32, and the features are warped from their bf16 rounding
            src_f = _nhwc(self._extract(inputs["color"][:, i], stages=1)[0])
            feats.append(self._grid_sample(self._cd(src_f), coords))
        return feats

    def _warp_features_cropped(self, inputs, outputs, disp0, ri, rj):
        """The rotation pretext's perceptual branch: stage-0 features of each
        source frame's crop at (ri, rj), warped with the crop of the
        full-resolution disparity at half the crop's size. The intrinsics
        are K/2, with no correction for the crop offset, as in the JAX
        package."""
        c = self.cfg
        size = c.pretext_resize
        disp = crop(resize_bilinear(disp0, c.height, c.width), ri, rj, size)
        _, depth = disp_to_depth(resize_bilinear(disp, size // 2, size // 2), c.min_depth,
                                 c.max_depth)
        K2 = scale_intrinsics(inputs["K"], 0.5, 0.5)
        inv_K2 = invert_intrinsics(K2)
        feats = []
        for i in range(1, c.num_frames):
            coords = warp_coords(depth, inv_K2, K2, self._frame_T(inputs, outputs, i))
            src = crop(inputs["color"][:, i], ri, rj, size)
            src_f = _nhwc(self._extract(src, stages=1)[0])
            feats.append(self._grid_sample(self._cd(src_f), coords))
        return feats

    def _equivariant_outputs(self, inputs, outputs):
        """Per source frame: the erase mask warped, nearest, at each scale's
        disparity, with the JAX package's swapped (K, inv_K) arguments; and
        the ImageDecoder's decoding of the source's deepest extractor stage
        warped into the target at that stage's own intrinsics. The JAX
        package warps all five stages, and its decoder reads the deepest
        alone; the port warps that one."""
        c = self.cfg
        mask = inputs["mask"]
        res_imgs, masks = {}, {}
        for i in range(1, c.num_frames):
            T = self._frame_T(inputs, outputs, i)
            masks[i] = []
            for s in c.scales:
                disp = resize_bilinear(outputs["disps"][s], c.height, c.width)
                _, depth = disp_to_depth(disp, c.min_depth, c.max_depth)
                coords = warp_coords(depth, inputs["K"], inputs["inv_K"], T)
                masks[i].append(self._grid_sample(mask, coords, method="nearest"))
            src_f = _nhwc(self._extract(inputs["color"][:, i])[4])
            fh, fw = src_f.shape[1], src_f.shape[2]
            _, depth = disp_to_depth(resize_bilinear(outputs["disps"][0], fh, fw), c.min_depth,
                                     c.max_depth)
            Kf = scale_intrinsics(inputs["K"], 1.0 / (c.width // fw), 1.0 / (c.height // fh))
            coords = warp_coords(depth, invert_intrinsics(Kf), Kf, T)
            warped = _nchw(self._grid_sample(src_f, coords))
            res_imgs[i] = [_nhwc(x) for x in self.image_decoder([None] * 4 + [warped])]
        return {"res_imgs": res_imgs, "masks": masks}

    # -------------------------------------------------------------- losses

    def _compute_losses(self, inputs, outputs, features, automask=None):
        c = self.cfg
        n_scales = len(c.scales)
        target = inputs["color"][:, 0]
        mask = inputs.get("mask")
        loss_dict: Dict[str, torch.Tensor] = {}

        if features is not None and c.joint_extractor:
            for i, f in enumerate(features):
                loss_dict[f"feature_regularization_loss/{i}"] = (
                    feature_regularization_loss(self._cd(_nhwc(f)), target, c.dis, c.cvt)
                    / (2**i) / 5.0)

        # the equivariant preset has no perceptual term
        if features is not None and c.perception_weight > 0 and not c.equivariant:
            if c.im_rot:
                # crop-matched: the extractor's stage 0 on the target's crop
                ri, rj = outputs["crop_offset"]
                tgt_crop = crop(target, ri, rj, c.pretext_resize)
                tgt_f = self._cd(_nhwc(self._extract(tgt_crop, stages=1)[0]))
                warped_feats = self._warp_features_cropped(inputs, outputs,
                                                           outputs["disps"][0], ri, rj)
            else:
                tgt_f = self._cd(_nhwc(features[0]))
                warped_feats = self._warp_features(inputs, outputs, outputs["disps"][0])
            percep = [perceptional_loss(tgt_f, sf) for sf in warped_feats]
            min_percep = torch.cat(percep, dim=-1).min(dim=-1).values
            loss_dict["min_perceptional_loss"] = c.perception_weight * min_percep.mean()

        if c.im_rot:
            loss_dict["ssl_rot_loss"] = cross_entropy_with_batch_softmax(
                outputs["rot_predicts"], outputs["rot_gt"]) * c.pretext_weight
        eq = self._equivariant_outputs(inputs, outputs) if c.equivariant else None

        # identity candidates first, so that an exact tie keeps the pixel
        # automasked (the fused path) or the noise breaks it (the unfused
        # one); they and the target are input frames, so only the warped
        # candidates get a gradient
        idents = [inputs["color"][:, i] for i in range(1, c.num_frames)] if c.automask else []
        n_id = len(idents)
        # the unfused path's, in float32 whatever the compute dtype, as in
        # JAX (`tripled_tpu/models/net.py:702-718`); they do not depend on
        # the scale
        ident_losses = ([] if c.use_pallas_photometric
                        else [reprojection_loss(p, target) for p in idents])
        for s in c.scales:
            disp = outputs["disps"][s]

            if "res_imgs" in outputs:
                res = outputs["res_imgs"][s]
                h, w = res.shape[1], res.shape[2]
                rec = reprojection_loss(res, resize_bilinear(target, h, w))
                if c.inpaint and mask is not None:
                    rec = erased_mean(rec, resize_bilinear(mask, h, w))
                else:
                    rec = rec.mean()
                loss_dict[f"img_reconstruct_loss/{s}"] = rec / n_scales * c.img_reconstruct_weight

            warped = self._warp_colors(inputs, outputs, disp)
            if c.use_pallas_photometric:
                # the slabs in the compute dtype; the kernels compute in float32
                preds = self._cd(torch.stack(idents + warped, dim=1))
                min_rec, _ = fused_min_reprojection(
                    self._cd(target), preds, grad_ks=tuple(range(n_id, preds.shape[1])),
                    need_target_grad=False)
            else:
                noise = None
                if ident_losses:
                    # drawn for the global batch; the rank keeps its rows
                    b, h, w = ident_losses[0].shape[:3]
                    noise = rank_rows(torch.randn(
                        (b * world_size(), h, w, len(ident_losses)), generator=automask,
                        dtype=target.dtype, device=target.device)) * 1e-5
                min_rec = min_reprojection_with_automask(
                    [reprojection_loss(p, target) for p in warped], ident_losses, noise)
            loss_dict[f"min_reconstruct_loss/{s}"] = min_rec.mean() / n_scales

            if eq is not None:
                loss_dict[f"min_equivariant_loss/{s}"] = (
                    c.equivariant_weight * self._equivariant_loss(inputs, eq, s) / n_scales)

            if c.disp_norm:
                disp = disp / (disp.mean(dim=(1, 2), keepdim=True) + 1e-7)
            loss_dict[f"smooth_loss/{s}"] = (
                c.smoothness_weight * smooth_loss(disp, target) / (2**s) / n_scales)

        if c.auto_res_weight > 0 and "auto_res" in outputs:
            loss_dict["auto_res_loss"] = (
                perceptional_loss(target, outputs["auto_res"][0]).mean() * c.auto_res_weight)

        if c.d2g_weight > 0:
            loss_dict["depth_to_gray_loss"] = self._distill_gs_loss(inputs, outputs)
        if c.colorize_weight > 0 and not c.sep_colorize:
            loss_dict["colorize_loss"] = self._distill_colorize_loss(inputs, outputs)
        # the colorize decoder's sigmoid output in [0, 1] is scored against
        # ab in [-1, 1], as in the JAX package
        if c.sep_colorize and c.colorize_weight > 0:
            loss_dict["distill_colorize_loss"] = self._sep_loss(
                outputs["gt_ab"], outputs["sep_colorize"][0], mask) * c.colorize_weight
        if c.sep_inpaint and c.inpaint_weight > 0:
            loss_dict["distill_inpaint_loss"] = self._sep_loss(
                target, outputs["sep_inpaint"][0], mask) * c.inpaint_weight
        if c.map_pose and c.map_pose_weight > 0:
            for i in range(1, c.num_frames):
                if c.frame_ids[i] == "s":
                    continue
                labels = inputs["map_params"][:, i - 1, 0].long()
                logp = torch.log_softmax(outputs["map_logits"][i], dim=-1)
                loss_dict[f"map_pose_loss/{i}"] = (
                    -logp.gather(1, labels[:, None]).mean() * c.map_pose_weight)
        return loss_dict

    def _equivariant_loss(self, inputs, eq, s):
        """The least over source frames of the decoded source's SSIM + L1
        loss against that frame, on the pixels its warped erase mask
        erased. A frame whose warped mask erased nothing gives 0: the JAX
        package guards the reference's division there. Sums and the least
        are over the global batch: with more than one rank, each frame's
        erased count is summed over the ranks and the frame whose global
        mean is least is taken (`parallel.dist.global_min`)."""
        losses = []
        world = world_size()
        for i in range(1, self.cfg.num_frames):
            res = eq["res_imgs"][i][s]
            h, w = res.shape[1], res.shape[2]
            l = reprojection_loss(res, resize_bilinear(inputs["color"][:, i], h, w))
            erased = 1 - resize_bilinear(eq["masks"][i][s], h, w)
            num, denom = (l * erased).sum(), erased.sum()
            if world > 1:  # the nearest-warped mask's count has no gradient
                num, denom = num * world, global_sum(denom)
            losses.append(torch.where(denom > 0, num, torch.zeros_like(num))
                          / denom.clamp_min(1.0))
        return global_min(torch.stack(losses))

    def _sep_loss(self, gt, pred, mask):
        l = perceptional_loss(gt, pred)
        return erased_mean(l, mask) if self.cfg.use_distill_mask and mask is not None else l.mean()

    # ---------------------------------------------------------- distill

    def _full_res_disp(self, outputs):
        return resize_bilinear(outputs["disps"][0], self.cfg.height, self.cfg.width)

    def _surface_normal(self, disp):
        """(normal + 1) / 2 of the depth map, from its central differences
        (one-sided at the borders), NHWC."""
        _, depth = disp_to_depth(disp, self.cfg.min_depth, self.cfg.max_depth)
        d = depth[..., 0]
        dy, dx = torch.gradient(d, dim=(1, 2))
        normal = torch.stack([-dx, -dy, torch.ones_like(d)], dim=-1)
        return (normal / torch.linalg.norm(normal, dim=-1, keepdim=True) + 1.0) / 2.0

    def _distill_gs_loss(self, inputs, outputs):
        c = self.cfg
        disp = self._full_res_disp(outputs)
        if c.use_normal:
            disp = self._surface_normal(disp)[..., :2]
        target = inputs["color"][:, 0]
        gt = rgb_to_l(target) if c.use_lab else rgb_to_gray(target)
        mask = inputs.get("mask")
        if c.use_mask and mask is not None:
            # under use_normal the JAX package takes mask[..., :2]: of a
            # 1-channel mask, the same channel, broadcast over the normal's two
            m = mask[..., :1]
            return erased_mean(perceptional_loss(gt, self.depth_to_gray(disp * m)),
                               m) * c.d2g_weight
        return perceptional_loss(gt, self.depth_to_gray(disp)).mean() * c.d2g_weight

    def _distill_colorize_loss(self, inputs, outputs):
        c = self.cfg
        disp = self._full_res_disp(outputs)
        if c.use_normal:
            disp = torch.cat([disp, self._surface_normal(disp)[..., :2]], dim=-1)
        lab = rgb2lab(inputs["color"][:, 0])
        net_in = torch.cat([disp, lab[..., 0:1]], dim=-1)
        mask = inputs.get("mask")
        if c.use_mask and mask is not None:
            m = mask[..., :1]  # broadcast over the head's inputs, as in JAX
            return erased_mean(perceptional_loss(lab[..., 1:], self.colorize_net(net_in * m)),
                               m) * c.colorize_weight
        return perceptional_loss(lab[..., 1:], self.colorize_net(net_in)).mean() * c.colorize_weight
