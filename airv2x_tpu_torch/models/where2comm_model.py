"""Airv2x Where2comm model (counterpart of
airv2x_tpu/models/where2comm_model.py), for the det and seg tasks, in eval
and (``model.train()``) train mode.

hetero encode -> shared BEV backbone -> shrink -> single-agent confidence
(det: the cls head; seg: the seg head's cropped features) -> Where2comm
multi-scale fusion (rerunning the backbone stages) -> shrink -> detection
heads or the BEV segmentation head. The backbone, ``shrink_conv`` and the
heads are applied twice with shared weights: the same module objects,
registered once.

Public outputs keep the JAX package's NHWC layout: det psm (B, H, W, A*C),
rm (B, H, W, 7A), obj (B, H, W, A); seg dynamic_seg (B, S, S, Cd),
static_seg (B, S, S, Cs); and the scalar comm_rate.
"""

from __future__ import annotations

from torch import nn

from airv2x_tpu_torch.models.base import HeteroLidarEncoder, SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.fusion.where2comm import Where2commFusion
from airv2x_tpu_torch.models.heads import BevSegHead, DetectionHeads
from airv2x_tpu_torch.models.nn import DownsampleConv


class Airv2xWhere2comm(nn.Module):
    # the train step passes ``comm_u`` / ``generator`` (parallel/train.py)
    DRAWS_KEEP_FRACTION = True

    def __init__(self, args: dict):
        super().__init__()
        self.task = args["task"]
        if self.task not in ("det", "seg"):
            raise ValueError(f"unknown task {self.task!r}")
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
        if not w2c["multi_scale"]:
            raise NotImplementedError(
                "single-scale Where2comm on the AirV2X model is not ported")
        if int(w2c.get("attn_heads", 0)) or w2c["fully"] or gauss is None:
            raise NotImplementedError(
                "only gaussian-smoothed, confidence-gated Where2comm without "
                "multi-head attention is ported")
        self.fusion_net = Where2commFusion(
            threshold=comm.get("threshold", 0.01),
            k_size=gauss["k_size"],
            c_sigma=gauss["c_sigma"],
        )
        if self.task == "det":
            if not args.get("obj_head", True):
                raise NotImplementedError("decode needs the objectness head")
            self.heads = DetectionHeads(
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

    def _shrink(self, x):
        return x if self.shrink_conv is None else self.shrink_conv(x)

    def encode(self, batch, mark=None):
        """Stage 1: points and camera images -> (B, L, ny, nx, C) BEV
        features; ``mark`` times the camera encoders' stages (see
        ``LSSCameraEncoder.forward``)."""
        return self.encoder(batch, mark)

    def single_psm(self, x):
        """Stage 2: backbone + shrink + single-agent confidence per agent:
        det (B*L, A*C, H', W') cls logits; seg the seg head's cropped
        features (B*L, C, S', S'), whose sigmoid max over channels is the
        confidence, as in the reference. (The JAX package also computes the
        seg logits there and discards them; XLA drops that work.)"""
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        feats_2d, _ = self.backbone(flat)
        feats_2d = self._shrink(feats_2d)
        if self.task == "det":
            return self.heads.cls_head(feats_2d)
        return self.seg_head.crop(feats_2d)

    def fuse(self, x, psm_single, agent_mask, comm_u=None, generator=None):
        """Stage 3: Where2comm fusion + shrink + heads -> NHWC outputs.
        ``comm_u`` / ``generator`` feed train-mode communication."""
        b, l = x.shape[:2]
        psm = psm_single.reshape(b, l, *psm_single.shape[1:])
        fused, rate = self.fusion_net(x, psm, agent_mask, self.backbone,
                                      comm_u, generator)
        fused = self._shrink(fused)
        if self.task == "det":
            out = {k: v.permute(0, 2, 3, 1)
                   for k, v in self.heads(fused).items()}
        else:
            out = self.seg_head(fused)
        out["comm_rate"] = rate
        return out

    def forward(self, batch, comm_u=None, generator=None):
        """``comm_u`` (B,) keep fractions, or a CPU ``generator`` to draw
        them from, in train mode; eval mode ignores both."""
        x = self.encode(batch)
        return self.fuse(x, self.single_psm(x), batch["agent_mask"], comm_u,
                         generator)
