"""The camera-only LSS baseline (counterpart of
airv2x_tpu/models/lss_model.py), det and seg, in eval and train mode.

One agent's cameras -> ``LSSCameraEncoder`` -> ``BaseBEVBackbone`` -> the
optional ``DownsampleConv`` shrink -> detection heads or the BEV
segmentation head. Only the ego type's slot 0 is read: nothing is
communicated, so ``comm_rate`` is 0.

The stage methods ``encode`` / ``backbone`` / ``heads`` split ``forward``
for per-stage timing, as ``PostBackboneFusionModel``'s do. The encoder, the
backbone and the detection heads live in ``lss_encoder``, ``bev_backbone``
and ``det_heads`` (flax scopes ``lss_encoder``, ``backbone`` and
``heads``). Public outputs keep the JAX package's NHWC layout.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.camera.lss import LSSCameraEncoder
from airv2x_tpu_torch.models.heads import BevSegHead, DetectionHeads
from airv2x_tpu_torch.models.nn import DownsampleConv


class LiftSplatShoot(nn.Module):
    """``lift_splat_shoot_airv2x`` / ``lift_splat_shoot``."""

    FLAX_NAMES = {"bev_backbone": "backbone", "det_heads": "heads"}

    def __init__(self, args: dict):
        super().__init__()
        self.task = args["task"]
        if self.task not in ("det", "seg"):
            raise ValueError(f"unknown task {self.task!r}")
        self.ego = args.get("ego_type", "vehicle")
        self.layout = SlotLayout.from_args(args)
        self.lss_encoder = LSSCameraEncoder(args[self.ego]["cam"])
        bb = (args.get("modality_fusion") or args)["base_bev_backbone"]
        self.bev_backbone = BaseBEVBackbone(
            in_ch=self.lss_encoder.out_channels,
            layer_nums=bb["layer_nums"],
            layer_strides=bb["layer_strides"],
            num_filters=bb["num_filters"],
            upsample_strides=bb["upsample_strides"],
            num_upsample_filters=bb["num_upsample_filter"],
        )
        head_in = self.bev_backbone.out_channels
        shrink = args["modality_fusion"].get("shrink_header", {})
        self.shrink_conv = None
        if shrink.get("use"):
            self.shrink_conv = DownsampleConv(
                head_in,
                dims=shrink["dim"],
                kernels=shrink["kernal_size"],
                strides=shrink["stride"],
                paddings=shrink.get("padding"),
            )
            head_in = self.shrink_conv.out_channels
        if self.task == "det":
            if not args.get("obj_head", True):
                raise NotImplementedError("decode needs the objectness head")
            self.det_heads = DetectionHeads(
                head_in, anchor_number=args["anchor_number"],
                num_class=args["num_class"])
        else:
            self.seg_head = BevSegHead(
                head_in,
                seg_branch=args["seg_branch"],
                seg_hw=args["seg_hw"],
                dynamic_class=args["dynamic_class"],
                static_class=args["static_class"],
                seg_res=args["seg_res"],
                cav_range=args["cav_range"],
            )

    def encode(self, batch, mark=None):
        """Stage 1: the ego type's slot-0 cameras -> (B, ny, nx, C) BEV
        features; ``mark`` times the camera encoder's stages."""
        cam = batch[f"cam_{self.ego}"]
        return self.lss_encoder({k: v[:, 0] for k, v in cam.items()}, mark)

    def backbone(self, x):
        """Stage 2: backbone + shrink -> (B, C, H, W), stored
        channels-last."""
        feats, _ = self.bev_backbone(x.permute(0, 3, 1, 2))
        if self.shrink_conv is not None:
            feats = self.shrink_conv(feats)
        return feats

    def heads(self, feats):
        """Stage 3: det psm / rm / obj or seg dynamic / static logits, NHWC,
        and comm_rate 0."""
        if self.task == "det":
            x = feats.to(self.det_heads.cls_head.weight.dtype)
            out = {k: v.permute(0, 2, 3, 1) for k, v in self.det_heads(x).items()}
        else:
            out = self.seg_head(feats.to(next(self.seg_head.parameters()).dtype))
        out["comm_rate"] = torch.zeros((), dtype=torch.float32,
                                       device=feats.device)
        return out

    def forward(self, batch):
        return self.heads(self.backbone(self.encode(batch)))
