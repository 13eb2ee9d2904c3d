"""Airv2x Where2comm detector, eval mode (counterpart of
airv2x_tpu/models/where2comm_model.py, det task).

hetero encode -> shared BEV backbone -> shrink -> single-agent confidence
head -> Where2comm multi-scale fusion (rerunning the backbone stages) ->
shrink -> detection heads. The backbone, ``shrink_conv`` and ``heads`` are
applied twice with shared weights: the same module objects, registered once.

Public outputs keep the JAX package's NHWC layout: psm (B, H, W, A*C),
rm (B, H, W, 7A), obj (B, H, W, A), and the scalar comm_rate.
"""

from __future__ import annotations

from torch import nn

from airv2x_tpu_torch.models.base import HeteroLidarEncoder, SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.fusion.where2comm import Where2commFusion
from airv2x_tpu_torch.models.heads import DetectionHeads
from airv2x_tpu_torch.models.nn import DownsampleConv


class Airv2xWhere2comm(nn.Module):
    def __init__(self, args: dict):
        super().__init__()
        if args["task"] != "det":
            raise NotImplementedError("only the det task is ported")
        self.layout = SlotLayout.from_args(args)
        self.encoder = HeteroLidarEncoder(args, args["preprocess"], self.layout)
        mod = args.get("modality_fusion") or args
        bb = mod["base_bev_backbone"]
        self.backbone = BaseBEVBackbone(
            in_ch=self.encoder.out_channels,
            layer_nums=bb["layer_nums"],
            layer_strides=bb["layer_strides"],
            num_filters=bb["num_filters"],
            upsample_strides=bb["upsample_strides"],
            num_upsample_filters=bb["num_upsample_filter"],
        )
        head_in = self.backbone.out_channels
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

        w2c = args["where2com_fusion"]
        comm = w2c.get("communication", {})
        gauss = comm.get("gaussian_smooth")
        if int(w2c.get("attn_heads", 0)) or w2c["fully"] or gauss is None:
            raise NotImplementedError(
                "only gaussian-smoothed, confidence-gated Where2comm without "
                "multi-head attention is ported")
        if not args.get("obj_head", True):
            raise NotImplementedError("decode needs the objectness head")
        self.fusion_net = Where2commFusion(
            multi_scale=w2c["multi_scale"],
            threshold=comm.get("threshold", 0.01),
            k_size=gauss["k_size"],
            c_sigma=gauss["c_sigma"],
        )
        self.heads = DetectionHeads(
            head_in,
            anchor_number=args["anchor_number"],
            num_class=args["num_class"],
        )

    def _shrink(self, x):
        return x if self.shrink_conv is None else self.shrink_conv(x)

    def encode(self, batch):
        """Stage 1: points -> (B, L, ny, nx, C) BEV features."""
        return self.encoder(batch)

    def single_psm(self, x):
        """Stage 2: backbone + shrink + cls head per agent ->
        (B*L, A*C, H', W') single-agent confidence logits."""
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        feats_2d, _ = self.backbone(flat)
        return self.heads.cls_head(self._shrink(feats_2d))

    def fuse(self, x, psm_single, agent_mask):
        """Stage 3: Where2comm fusion + shrink + heads -> NHWC outputs."""
        b, l = x.shape[:2]
        psm = psm_single.reshape(b, l, *psm_single.shape[1:])
        fused, rate = self.fusion_net(x, psm, agent_mask, self.backbone)
        out = {k: v.permute(0, 2, 3, 1)
               for k, v in self.heads(self._shrink(fused)).items()}
        out["comm_rate"] = rate
        return out

    def forward(self, batch):
        x = self.encode(batch)
        return self.fuse(x, self.single_psm(x), batch["agent_mask"])
