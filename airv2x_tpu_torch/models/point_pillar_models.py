"""The OPV2V ``point_pillar_*`` family's shared spine, eval mode (counterpart
of airv2x_tpu/models/point_pillar_models.py: ``PointPillarBase``; the
family's fusion models other than SCOPE wait).

Homogeneous (vehicle-only) PointPillars: one shared sort-free pillar
encoder (``FastPillarBEV``, one K1 launch per call over every agent's
cloud) -> the ResNet (``base_bev_backbone.resnet``) or the plain BEV
backbone -> the ``DownsampleConv`` shrink -> binary heads (psm: one channel
per anchor, rm: 7 per anchor; with ``num_class > 1`` the multiclass layout
and an objectness head). The agent axis is a ``SlotLayout`` with every slot
a vehicle. Without a fusion the ego slot's features go to the heads.

Public outputs keep the JAX package's NHWC layout. The classic voxel
encoder, the ``NaiveCompressor`` (``compression > 0``) and radar points are
not ported and raise.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.nn import DownsampleConv
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV


class PointPillarBase(nn.Module):
    def __init__(self, args: dict):
        super().__init__()
        max_cav = args.get("max_cav", 5)
        if isinstance(max_cav, dict):
            max_cav = sum(max_cav.values())
        self.layout = SlotLayout(counts=(int(max_cav), 0, 0))
        pre = args["preprocess"]
        pv = args["pillar_vfe"]
        if not pre["args"].get("fast_pillars", True) or len(pv["num_filters"]) != 1:
            raise NotImplementedError("the classic voxel path is not ported")
        self.vfe = FastPillarBEV(
            num_filters=pv["num_filters"],
            voxel_size=pre["args"]["voxel_size"],
            lidar_range=pre["cav_lidar_range"],
            use_norm=pv["use_norm"],
            with_distance=pv["with_distance"],
            use_absolute_xyz=pv["use_absolute_xyz"],
        )
        bb = args["base_bev_backbone"]
        kw = dict(layer_nums=bb["layer_nums"], layer_strides=bb["layer_strides"],
                  num_filters=bb["num_filters"],
                  upsample_strides=bb["upsample_strides"],
                  num_upsample_filters=bb["num_upsample_filter"])
        if bb.get("resnet"):
            self.backbone = ResNetBEVBackbone(
                inplanes=int(bb.get("inplanes", pv["num_filters"][-1])), **kw)
        else:
            self.backbone = BaseBEVBackbone(in_ch=self.vfe.out_c, **kw)
        head_in = self.backbone.out_channels
        # a shrink_header block without a 'use' key is on when it has dims
        shrink = args.get("shrink_header") or {}
        self.shrink_conv = None
        if shrink.get("use", bool(shrink.get("dim"))):
            self.shrink_conv = DownsampleConv(
                head_in, dims=shrink["dim"], kernels=shrink["kernal_size"],
                strides=shrink["stride"], paddings=shrink.get("padding"))
            head_in = self.shrink_conv.out_channels
        if int(args.get("compression", 0)) > 0:
            raise NotImplementedError("NaiveCompressor is not ported")
        self.num_class = int(args.get("num_class", 1))
        anchors = int(args["anchor_number"])
        self.cls_head = nn.Conv2d(head_in, anchors * self.num_class, 1)
        self.reg_head = nn.Conv2d(head_in, 7 * anchors, 1)
        self.obj_head = None
        if self.num_class > 1 and args.get("obj_head", True):
            self.obj_head = nn.Conv2d(head_in, anchors, 1)

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError(
                "training the point_pillar family is not ported")
        return super().train(False)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the convolutions run in (bf16 after the serving cast)."""
        return self.cls_head.weight.dtype

    def encode(self, batch):
        """points (B, L, N, 4), points_mask (B, L, N), agent_mask (B, L) ->
        (B, L, ny, nx, C) BEV features, zero for absent agents: one K1
        launch over the B * L clouds."""
        if "radar_points" in batch:
            raise NotImplementedError("radar points are not ported")
        bev = self.vfe(batch["points"], batch["points_mask"])
        return bev * batch["agent_mask"][:, :, None, None, None].to(bev.dtype)

    def backbone_2d(self, x):
        """(B, L, H, W, C) -> backbone + shrink per agent -> (B, L, C', H', W')."""
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        feats, _ = self.backbone(flat)
        if self.shrink_conv is not None:
            feats = self.shrink_conv(feats)
        return feats.reshape((b, l) + feats.shape[1:])

    def heads(self, x):
        """(B, C, H, W) -> NHWC psm / rm (/ obj) of the heads."""
        out = {"psm": self.cls_head(x), "rm": self.reg_head(x)}
        if self.obj_head is not None:
            out["obj"] = self.obj_head(x)
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}

    def forward(self, batch):
        """Without a fusion: the ego slot's features to the heads."""
        grouped = self.backbone_2d(self.encode(batch))
        out = self.heads(grouped[:, 0])
        out["comm_rate"] = torch.zeros((), dtype=torch.float32,
                                       device=grouped.device)
        return out
