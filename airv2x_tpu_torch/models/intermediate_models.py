"""Intermediate-fusion models (counterpart of
airv2x_tpu/models/intermediate_models.py), det and seg, in eval and train mode.

``PostBackboneFusionModel`` is the shared spine: hetero encode -> shared
BEV backbone (one pass over every agent) -> shrink -> a fusion of the
agents' maps into the ego map -> detection heads or the BEV segmentation
head. Each collaboration method supplies its fusion:

  * airv2x_attfusion / airv2x_intermediate: per-pixel ego-query attention
  * airv2x_maxfusion: the masked elementwise max
  * airv2x_cobevt: fused-axial swap attention (``fusion/cobevt.py``)
  * airv2x_v2vnet: ConvGRU message passing (``fusion/v2vnet.py``)
  * airv2x_when2com: the learned handshake (``fusion/when2com.py``)

The stage methods ``encode`` / ``backbone`` / ``fuse`` / ``heads`` split
``forward`` for per-stage timing. The backbone and the detection heads live
in ``bev_backbone`` and ``det_heads`` (flax scopes ``backbone`` and
``heads``), so that the stage methods can carry those names. Public outputs
keep the JAX package's NHWC layout, and the scalar ``comm_rate`` is 1: every
agent sends its whole map.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import HeteroLidarEncoder, SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.fusion.cobevt import SwapFusionEncoder
from airv2x_tpu_torch.models.fusion.common import (
    ego_agent_attention, max_fusion)
from airv2x_tpu_torch.models.fusion.v2vnet import V2VNetFusion
from airv2x_tpu_torch.models.fusion.when2com import When2comFusion
from airv2x_tpu_torch.models.heads import BevSegHead, DetectionHeads
from airv2x_tpu_torch.models.nn import DownsampleConv


class PostBackboneFusionModel(nn.Module):
    """The shared spine; a subclass gives ``make_fusion`` (the fusion module
    or None, stored as ``fusion_net``) and ``fuse``."""

    FLAX_NAMES = {"bev_backbone": "backbone", "det_heads": "heads"}

    def __init__(self, args: dict):
        super().__init__()
        self.task = args["task"]
        if self.task not in ("det", "seg"):
            raise ValueError(f"unknown task {self.task!r}")
        self.layout = SlotLayout.from_args(args)
        self.encoder = HeteroLidarEncoder(args, args["preprocess"], self.layout)
        # cobevt / sicp configs keep the trunk keys at the top level
        mod = args.get("modality_fusion") or args
        bb = mod["base_bev_backbone"]
        self.bev_backbone = BaseBEVBackbone(
            in_ch=self.encoder.out_channels,
            layer_nums=bb["layer_nums"],
            layer_strides=bb["layer_strides"],
            num_filters=bb["num_filters"],
            upsample_strides=bb["upsample_strides"],
            num_upsample_filters=bb["num_upsample_filter"],
        )
        head_in = self.bev_backbone.out_channels
        shrink = mod.get("shrink_header", {})
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
        if int(mod.get("compression", 0)) > 0:
            raise NotImplementedError("NaiveCompressor is not ported")
        self.fusion_net = self.make_fusion(args, head_in)
        if self.task == "det":
            if not args.get("obj_head", True):
                raise NotImplementedError("decode needs the objectness head")
            self.det_heads = DetectionHeads(
                head_in,
                anchor_number=args["anchor_number"],
                num_class=args["num_class"],
            )
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

    def make_fusion(self, args: dict, channels: int) -> nn.Module | None:
        raise NotImplementedError

    def encode(self, batch, mark=None):
        """Stage 1: points (and camera images) -> (B, L, ny, nx, C) BEV
        features; ``mark`` times a camera encoder's stages."""
        return self.encoder(batch, mark)

    def backbone(self, x):
        """Stage 2: backbone + shrink per agent -> (B, L, C, H, W), stored
        channels-last."""
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        feats, _ = self.bev_backbone(flat)
        if self.shrink_conv is not None:
            feats = self.shrink_conv(feats)
        return feats.reshape((b, l) + feats.shape[1:])

    def fuse(self, feats, batch):
        """Stage 3: the agents' maps (B, L, C, H, W) -> the fused ego map
        (B, C, H, W)."""
        raise NotImplementedError

    def heads(self, fused):
        """Stage 4: det psm / rm / obj or seg dynamic / static logits, NHWC,
        and comm_rate 1."""
        if self.task == "det":
            x = fused.to(self.det_heads.cls_head.weight.dtype)
            out = {k: v.permute(0, 2, 3, 1) for k, v in self.det_heads(x).items()}
        else:
            dt = next(self.seg_head.parameters()).dtype
            out = self.seg_head(fused.to(dt))
        out["comm_rate"] = torch.ones((), dtype=torch.float32,
                                      device=fused.device)
        return out

    def forward(self, batch):
        return self.heads(self.fuse(self.backbone(self.encode(batch)), batch))


class Airv2xAttFusion(PostBackboneFusionModel):
    """Per-pixel scaled-dot attention from the ego over the present agents
    (``airv2x_attfusion`` and ``airv2x_intermediate``)."""

    def make_fusion(self, args, channels):
        return None

    def fuse(self, feats, batch):
        return ego_agent_attention(feats, batch["agent_mask"])


class Airv2xMaxFusion(PostBackboneFusionModel):
    """The elementwise max over the present agents."""

    def make_fusion(self, args, channels):
        return None

    def fuse(self, feats, batch):
        return max_fusion(feats, batch["agent_mask"])


class Airv2xCoBEVT(PostBackboneFusionModel):
    """Fused-axial swap attention; its ``agent_size`` is the slot count
    (``max_cav`` summed over the types), as the JAX package injects it."""

    def make_fusion(self, args, channels):
        fax = dict(args["fax_fusion"], agent_size=self.layout.total)
        return SwapFusionEncoder(fax)

    def fuse(self, feats, batch):
        return self.fusion_net(feats, batch["agent_mask"])


class Airv2xV2VNet(PostBackboneFusionModel):
    def make_fusion(self, args, channels):
        return V2VNetFusion(args["v2vfusion"], channels)

    def fuse(self, feats, batch):
        return self.fusion_net(feats, batch["agent_mask"],
                               batch["pairwise_t_full"])


class Airv2xWhen2com(PostBackboneFusionModel):
    def make_fusion(self, args, channels):
        return When2comFusion(args["when2com_fusion"], channels)

    def fuse(self, feats, batch):
        return self.fusion_net(feats, batch["agent_mask"],
                               batch["pairwise_t_full"])
