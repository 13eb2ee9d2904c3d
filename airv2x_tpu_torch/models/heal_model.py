"""AirV2X HEAL (counterpart of airv2x_tpu/models/heal_model.py), det and seg,
in eval and train mode.

Hetero encode (LiDAR pillars, K1, or the LSS camera encoder per agent type)
-> a single-stage ResNet modality backbone per agent (``upsample_strides:
[]``: its last stage's map) -> the pyramid fusion (``fusion/pyramid.py``:
ResNeXt levels, occupancy-weighted warp-fuse into the ego frame, deblocks)
-> shrink -> detection heads or the BEV segmentation head, ``comm_rate`` 1.
The stage methods ``encode`` / ``backbone`` / ``fuse`` / ``heads`` split
``forward`` for per-stage timing, as ``PostBackboneFusionModel``'s do. The
multi-stage recipe's freezing is ``parallel/train.py:freeze_by_path``.

Where the args hold an ``alignnet`` key (no shipped config has one), an
``AlignNet`` (``models/alignnet.py``) aligns each agent's backbone map
before the pyramid, as the JAX package's HEAL applies it; STAMP reads no
such key.
"""

from __future__ import annotations

from torch import nn

from airv2x_tpu_torch.models.alignnet import AlignNet
from airv2x_tpu_torch.models.base import HeteroLidarEncoder, SlotLayout
from airv2x_tpu_torch.models.fusion.pyramid import PyramidFusion
from airv2x_tpu_torch.models.heads import BevSegHead, DetectionHeads
from airv2x_tpu_torch.models.intermediate_models import PostBackboneFusionModel
from airv2x_tpu_torch.models.nn import DownsampleConv
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone


class Airv2xHEAL(nn.Module):
    FLAX_NAMES = {"modality_backbone": "backbone", "det_heads": "heads"}

    def __init__(self, args: dict):
        super().__init__()
        self.args = args
        self.task = args["task"]
        if self.task not in ("det", "seg"):
            raise ValueError(f"unknown task {self.task!r}")
        self.layout = SlotLayout.from_args(args)
        pre = args["preprocess"]
        self.encoder = HeteroLidarEncoder(args, pre, self.layout)
        # the BEV grid's rows, from which the fuse reads the backbone's stride
        rng, vs = pre["cav_lidar_range"], pre["args"]["voxel_size"]
        self.grid_h = int(round((rng[4] - rng[1]) / vs[1]))
        self.discrete_ratio = float(vs[0])
        mod = args.get("modality_fusion") or args
        bb = mod["base_bev_backbone"]
        self.modality_backbone = ResNetBEVBackbone(
            layer_nums=bb["layer_nums"],
            layer_strides=bb["layer_strides"],
            num_filters=bb["num_filters"],
            upsample_strides=bb.get("upsample_strides", ()),
            num_upsample_filters=bb.get("num_upsample_filter", ()),
            inplanes=64,
            in_ch=self.encoder.out_channels,
        )
        self.alignnet = self.make_alignnet(args)
        self.make_adapters(args)
        self.pyramid = PyramidFusion(args["fusion_backbone"],
                                     inplanes=bb["num_filters"][-1],
                                     in_ch=self.adapted_channels())
        head_in = self.pyramid.out_channels
        shrink = mod.get("shrink_header", {})
        self.shrink_conv = None
        if shrink.get("use"):
            self.shrink_conv = DownsampleConv(
                head_in, dims=shrink["dim"], kernels=shrink["kernal_size"],
                strides=shrink["stride"], paddings=shrink.get("padding"))
            head_in = self.shrink_conv.out_channels
        if self.task == "det":
            if not args.get("obj_head", True):
                raise NotImplementedError("decode needs the objectness head")
            self.det_heads = DetectionHeads(
                head_in, anchor_number=args["anchor_number"],
                num_class=args["num_class"])
        else:
            self.seg_head = BevSegHead(
                head_in, seg_branch=args["seg_branch"], seg_hw=args["seg_hw"],
                dynamic_class=args["dynamic_class"],
                static_class=args["static_class"], seg_res=args["seg_res"],
                cav_range=args["cav_range"])

    def make_alignnet(self, args: dict):
        """The ``alignnet`` key's AlignNet on the backbone's maps, or None."""
        if "alignnet" not in args:
            return None
        return AlignNet(dict(args["alignnet"]), self.modality_backbone.out_channels)

    def make_adapters(self, args: dict) -> None:
        """STAMP's per-type adapters; HEAL has none."""

    def adapted_channels(self) -> int:
        return self.modality_backbone.out_channels

    def adapt(self, grouped):
        return grouped

    def encode(self, batch, mark=None):
        """Stage 1: (B, L, ny, nx, C) BEV features; ``mark`` times a camera
        encoder's stages."""
        return self.encoder(batch, mark)

    def backbone(self, x):
        """Stage 2: the modality backbone per agent (then HEAL's AlignNet,
        STAMP's adapters) -> (B, L, C, H, W)."""
        b, l, h, w, c = x.shape
        feats = self.modality_backbone(x.reshape(b * l, h, w, c).permute(0, 3, 1, 2))[0]
        if self.alignnet is not None:
            feats = self.alignnet(feats)
        return self.adapt(feats.reshape((b, l) + feats.shape[1:]))

    def fuse(self, feats, batch):
        """Stage 3: the pyramid fusion into the ego frame, then the shrink
        -> (B, C, H, W). HEAL reads the optional ``cam_crop_ratios``
        (B, L, 2), which no dataset fills."""
        fused, _ = self.pyramid.forward_collab(
            feats, batch["agent_mask"], batch["pairwise_t"],
            self.discrete_ratio, self.grid_h // feats.shape[-2],
            cam_crop_ratios=self.crop_ratios(batch))
        if self.shrink_conv is not None:
            fused = self.shrink_conv(fused)
        return fused

    def crop_ratios(self, batch):
        return batch.get("cam_crop_ratios")

    def heads(self, fused):
        """Stage 4: det psm / rm / obj or seg logits, NHWC, comm_rate 1."""
        return PostBackboneFusionModel.heads(self, fused)

    def forward(self, batch):
        return self.heads(self.fuse(self.backbone(self.encode(batch)), batch))
