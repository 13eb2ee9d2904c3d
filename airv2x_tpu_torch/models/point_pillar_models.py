"""The OPV2V / DAIR-V2X ``point_pillar_*`` family, in eval and train mode
(counterpart of airv2x_tpu/models/point_pillar_models.py).

Homogeneous (vehicle-only) PointPillars: one shared sort-free pillar
encoder (``FastPillarBEV``: one K1 launch per call over every agent's cloud
in eval, the plain scatter path in training) -> the ResNet
(``base_bev_backbone.resnet``) or the plain BEV backbone -> the
``DownsampleConv`` shrink -> a fusion of the agents' maps into the ego map
(``fuse``) -> binary heads (psm: one channel per anchor, rm: 7 per anchor;
with ``num_class > 1`` the multiclass layout and an objectness head). The
agent axis is a ``SlotLayout`` with every slot a vehicle.

The registered models and their fusion:

  * point_pillar: none, the ego slot's map (comm_rate 0);
  * point_pillar_intermediate / point_pillar_attfusion: per backbone stage,
    ego-query attention over the unfused stage maps, each fused level
    through its deblock (comm_rate: the count of nonzero stage features);
  * point_pillar_baseline_multiscale: the same per-stage structure with
    ``fusion_method`` max or att, usually on the ResNet backbone;
  * point_pillar_max / point_pillar_fcooper: the masked elementwise max,
    after warping the non-ego maps into the ego frame when the config has
    a ``v2vfusion`` block;
  * point_pillar_where2comm: single-scale Where2comm (the confidence mask
    from the shared cls head gates the maps, then ego-query attention);
  * point_pillar_v2xvit / _cobevt / _v2vnet / _when2com: the ported fusion
    modules (comm_rate 1);
  * point_pillar_disconet: DiscoNet's student, a per-pixel softmax over the
    present agents of weights that ``PixelWeightLayer`` predicts from
    [agent map, ego map], with the fused map as ``student_feature`` (NHWC)
    for the distillation loss;
  * point_pillar_sicp: SiCP's gated pairwise fusion (``fusion/sicp.py``);
    in train mode the ego alone through the shared heads as well.

How2comm (``how2comm_model.py``), CoAlign (``coalign_model.py``), the
attention backbones (``att_backbone_models.py``) and the V2X-R LiDAR +
4D-radar models (``radar_models.py``) build on the same spine; CoAlign
names its ResNet backbone ``res_bev_backbone``.

Public outputs keep the JAX package's NHWC layout. A config with
``fast_pillars: false`` or more than one PFN layer takes the classic voxel
path (``ops/voxelize.py`` -> ``models/pillar_vfe.py`` -> ``ops/scatter.py``).
The ``NaiveCompressor`` (``compression > 0``, and the per-stage
``base_bev_backbone.compression``) is not ported and raises. A radar cloud
in the batch (``radar_points`` / ``radar_points_mask``) is read only by the
models that fuse it.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BaseBEVBackbone
from airv2x_tpu_torch.models.fusion.cobevt import SwapFusionEncoder
from airv2x_tpu_torch.models.fusion.common import ego_agent_attention, max_fusion
from airv2x_tpu_torch.models.fusion.sicp import SpatialFusion
from airv2x_tpu_torch.models.fusion.v2vnet import V2VNetFusion
from airv2x_tpu_torch.models.fusion.v2xvit import V2XTransformer
from airv2x_tpu_torch.models.fusion.when2com import When2comFusion
from airv2x_tpu_torch.models.fusion.where2comm import Where2commFusion
from airv2x_tpu_torch.models.nn import BatchNorm2d, DownsampleConv
from airv2x_tpu_torch.models.pillar_vfe import PillarVFE, pillar_bev
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV
from airv2x_tpu_torch.ops.voxelize import pillar_kwargs, pillarize_batch
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


def _rate(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


class PointPillarBase(nn.Module):
    """The shared spine; without a fusion the ego slot's map goes to the
    heads. A subclass may set ``_force_classic_vfe`` (the classic voxel path
    whatever the config says) or ``_force_resnet_backbone`` (the ResNet
    backbone whatever ``base_bev_backbone.resnet`` says), and override
    ``backbone_in`` (the width of the map the backbone receives)."""

    _force_classic_vfe = False
    _force_resnet_backbone = False

    def __init__(self, args: dict):
        super().__init__()
        max_cav = args.get("max_cav", 5)
        if isinstance(max_cav, dict):
            max_cav = sum(max_cav.values())
        self.layout = SlotLayout(counts=(int(max_cav), 0, 0))
        pre = args["preprocess"]
        # BM2CP nests the trunk config (pc_params) and names its backbone and
        # shrink under modality_fusion, its backbone always the ResNet one
        pv = args.get("pillar_vfe") or args["pc_params"]["pillar_vfe"]
        self.pillar_kw = pillar_kwargs(pre)
        self.grid = self.pillar_kw["grid_size"]
        # the sort-free encoder serves single-PFN-layer configs; the classic
        # voxel path (pillarize -> PillarVFE -> scatter) the others
        self.fast_pillars = (bool(pre["args"].get("fast_pillars", True))
                             and len(pv["num_filters"]) == 1
                             and not self._force_classic_vfe)
        self.vfe = self.make_vfe(args)
        # CoAlign names its (ResNet) backbone res_bev_backbone, BM2CP its
        # modality_fusion.bev_backbone (ResNet too)
        bb = args.get("base_bev_backbone")
        if bb is None and "res_bev_backbone" in args:
            bb = dict(args["res_bev_backbone"], resnet=True)
        if bb is None:
            bb = dict(args["modality_fusion"]["bev_backbone"], resnet=True)
        kw = dict(layer_nums=bb["layer_nums"], layer_strides=bb["layer_strides"],
                  num_filters=bb["num_filters"],
                  upsample_strides=bb["upsample_strides"],
                  num_upsample_filters=bb["num_upsample_filter"])
        in_ch = self.backbone_in(args)
        if bb.get("resnet") or self._force_resnet_backbone:
            self.backbone = ResNetBEVBackbone(
                inplanes=int(bb.get("inplanes", pv["num_filters"][-1])),
                in_ch=in_ch, **kw)
        else:
            self.backbone = BaseBEVBackbone(in_ch=in_ch, **kw)
        # the map's (H, W) after the backbone: every deblock meets the first
        # stage's output upsampled by its own stride
        self.backbone_hw = tuple(
            g * int(bb["upsample_strides"][0]) // int(bb["layer_strides"][0])
            for g in (self.grid[1], self.grid[0]))
        if int(args.get("compression", 0)) > 0:
            raise NotImplementedError("NaiveCompressor is not ported")
        self.build_heads(args, self.backbone.out_channels)

    def make_vfe(self, args: dict, classic: bool = False) -> nn.Module:
        """A pillar encoder of the config's ``pillar_vfe`` on the shared
        grid: ``FastPillarBEV`` (K1) on the fast path unless ``classic``,
        else ``PillarVFE``."""
        pre = args["preprocess"]
        pv = args.get("pillar_vfe") or args["pc_params"]["pillar_vfe"]
        vfe_cls = FastPillarBEV if self.fast_pillars and not classic else PillarVFE
        return vfe_cls(
            num_filters=pv["num_filters"],
            voxel_size=pre["args"]["voxel_size"],
            lidar_range=pre["cav_lidar_range"],
            use_norm=pv["use_norm"],
            with_distance=pv["with_distance"],
            use_absolute_xyz=pv["use_absolute_xyz"],
        )

    def backbone_in(self, args: dict) -> int:
        """The width of the map the backbone receives: the VFE's."""
        return self.vfe.out_c

    def build_heads(self, args: dict, head_in: int) -> None:
        """The shrink (where the config has one) on maps of ``head_in``
        channels, then the heads on its output; ``feature_hw`` is the (H, W)
        of the maps the heads see."""
        # a shrink_header block without a 'use' key is on when it has dims
        shrink = args.get("shrink_header")
        if shrink is None and "modality_fusion" in args:
            shrink = args["modality_fusion"].get("shrink_header")
        shrink = shrink or {}
        self.shrink_conv = None
        self.feature_hw = self.backbone_hw
        if shrink.get("use", bool(shrink.get("dim"))):
            self.shrink_conv = DownsampleConv(
                head_in, dims=shrink["dim"], kernels=shrink["kernal_size"],
                strides=shrink["stride"], paddings=shrink.get("padding"))
            head_in = self.shrink_conv.out_channels
            pads = shrink.get("padding") or [1] * len(shrink["dim"])
            for k, s, p in zip(shrink["kernal_size"], shrink["stride"], pads):
                self.feature_hw = tuple((n + 2 * p - k) // s + 1
                                        for n in self.feature_hw)
        self.head_in = head_in
        self.num_class = int(args.get("num_class", 1))
        anchors = int(args["anchor_number"])
        self.cls_head = nn.Conv2d(head_in, anchors * self.num_class, 1)
        self.reg_head = nn.Conv2d(head_in, 7 * anchors, 1)
        self.obj_head = None
        if self.num_class > 1 and args.get("obj_head", True):
            self.obj_head = nn.Conv2d(head_in, anchors, 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the convolutions run in (bf16 after the serving cast)."""
        return self.cls_head.weight.dtype

    def encode_cloud(self, points, mask, vfe):
        """One cloud per agent, points (B, L, N, 4) and mask (B, L, N),
        through ``vfe`` -> (B, L, ny, nx, C): one K1 launch over the B * L
        clouds where ``vfe`` is a ``FastPillarBEV`` in eval mode (the classic
        path: the pillarization, the PFN layers and the scatter in
        PyTorch)."""
        if isinstance(vfe, FastPillarBEV):
            return vfe(points, mask)
        pil = pillarize_batch(points.flatten(0, 1), mask.flatten(0, 1),
                              **self.pillar_kw)
        return pillar_bev(vfe, pil, self.grid).unflatten(0, points.shape[:2])

    def encode(self, batch):
        """points (B, L, N, 4), points_mask (B, L, N), agent_mask (B, L) ->
        (B, L, ny, nx, C) BEV features, zero for absent agents. A radar
        cloud in the batch is not read here (only the LiDAR + radar models
        read it)."""
        bev = self.encode_cloud(batch["points"], batch["points_mask"], self.vfe)
        return bev * batch["agent_mask"][:, :, None, None, None].to(bev.dtype)

    def backbone_2d(self, x):
        """(B, L, H, W, C) -> backbone + shrink per agent -> (B, L, C', H', W')."""
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        feats, _ = self.backbone(flat)
        if self.shrink_conv is not None:
            feats = self.shrink_conv(feats)
        return feats.reshape((b, l) + feats.shape[1:])

    def fuse(self, grouped, batch):
        """The agents' maps (B, L, C, H, W) -> (the fused ego map (B, C, H, W),
        comm_rate); here the ego slot's map and rate 0."""
        return grouped[:, 0], _rate(0.0, grouped)

    def heads(self, x):
        """(B, C, H, W) -> NHWC psm / rm (/ obj) of the heads; x is cast to
        the heads' dtype (a warped map is f32 under a bf16 compute dtype)."""
        x = x.to(self.cls_head.weight.dtype)
        out = {"psm": self.cls_head(x), "rm": self.reg_head(x)}
        if self.obj_head is not None:
            out["obj"] = self.obj_head(x)
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}

    def forward(self, batch, **kw):
        """``kw`` go to ``fuse`` (Where2comm's keep fraction)."""
        fused, rate = self.fuse(self.backbone_2d(self.encode(batch)), batch,
                                **kw)
        out = self.heads(fused)
        out["comm_rate"] = rate
        return out


class PointPillar(PointPillarBase):
    """The single-agent baseline (``point_pillar``)."""


class _PerStageFusionBase(PointPillarBase):
    """Per-backbone-stage agent fusion: each stage's unfused maps feed the
    next stage, and a parameter-free fusion of each stage's maps over the
    agents feeds that stage's deblock; the fused levels are concatenated
    and shrunk."""

    FUSION_METHOD = "att"

    def __init__(self, args: dict):
        super().__init__(args)
        if int(args["base_bev_backbone"].get("compression", 0)) > 0:
            raise NotImplementedError(
                "the per-stage AutoEncoder compression is not ported")
        self.fusion_method = self.FUSION_METHOD

    def _fuse_scale(self, feats, agent_mask):
        if self.fusion_method == "att":
            return ego_agent_attention(feats, agent_mask)
        return max_fusion(feats, agent_mask)

    def forward(self, batch):
        x = self.encode(batch)
        b, l, h, w, c = x.shape
        flat = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        resnet = isinstance(self.backbone, ResNetBEVBackbone)
        if resnet:
            ms = self.backbone.get_multiscale_feature(flat)
        else:
            ms = []
            for i in range(len(self.backbone.stages)):
                flat = self.backbone.stage(i, flat)
                ms.append(flat)
        rate = sum((f != 0).float().sum() for f in ms)
        fused_ms = [self._fuse_scale(f.unflatten(0, (b, l)), batch["agent_mask"])
                    for f in ms]
        if resnet:
            fused = self.backbone.decode_multiscale(fused_ms)
        else:
            fused = self.backbone.finish(
                [self.backbone.deblock(i, f) for i, f in enumerate(fused_ms)])
        if self.shrink_conv is not None:
            fused = self.shrink_conv(fused)
        out = self.heads(fused)
        out["comm_rate"] = rate
        return out


class PointPillarIntermediate(_PerStageFusionBase):
    """AttFusion: per-stage scaled-dot attention from the ego over the
    present agents (``point_pillar_intermediate`` and
    ``point_pillar_attfusion``)."""


class PointPillarBaselineMultiscale(_PerStageFusionBase):
    """The multiscale single-fusion baseline: per-stage ``fusion_method``
    (max by default, or att) on the ResNet or the plain backbone."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.fusion_method = args.get("fusion_method", "max")


class PointPillarMax(PointPillarBase):
    """The masked elementwise max over the present agents
    (``point_pillar_max``, and ``point_pillar_fcooper``: F-Cooper is max
    fusion, for which the reference ships a config but no model file). With
    a ``v2vfusion`` block, each non-ego map is first warped into the ego
    frame by the ego row of ``pairwise_t_full`` (normalized affine)."""

    def __init__(self, args: dict):
        super().__init__(args)
        v2v = args.get("v2vfusion") or {}
        vs = v2v.get("voxel_size") or args["preprocess"]["args"]["voxel_size"]
        self.discrete_ratio = float(vs[0])
        self.downsample_rate = float(v2v.get("downsample_rate", 1))
        self.warp_fuse = "v2vfusion" in args

    def fuse(self, grouped, batch):
        if self.warp_fuse and "pairwise_t_full" in batch:
            h, w = grouped.shape[-2:]
            aff = normalized_pairwise_affine(
                batch["pairwise_t_full"], h, w, self.discrete_ratio,
                self.downsample_rate)[:, 0]
            cl = grouped.permute(0, 1, 3, 4, 2)
            warped = warp_affine_normalized(cl[:, 1:], aff[:, 1:])
            grouped = torch.cat([cl[:, :1], warped], dim=1).permute(0, 1, 4, 2, 3)
        return max_fusion(grouped, batch["agent_mask"]), _rate(1.0, grouped)


class PointPillarWhere2comm(PointPillarBase):
    """Single-scale Where2comm: the cls head's confidence of every agent's
    map gives the communication mask (in training a drawn keep fraction),
    which gates the maps before ego-query attention."""

    # the train step passes ``comm_u`` / ``generator`` (parallel/train.py)
    DRAWS_KEEP_FRACTION = True

    def __init__(self, args: dict):
        super().__init__(args)
        w2c = args["where2comm_fusion"]
        comm = w2c.get("communication", {})
        gauss = comm.get("gaussian_smooth")
        if w2c.get("fully", False) or gauss is None:
            raise NotImplementedError(
                "only gaussian-smoothed, confidence-gated Where2comm is ported")
        self.fusion_net = Where2commFusion(
            multi_scale=False, threshold=comm.get("threshold", 0.01),
            k_size=gauss["k_size"], c_sigma=gauss["c_sigma"])

    def fuse(self, grouped, batch, comm_u=None, generator=None):
        """``comm_u`` (B,) keep fractions, or a CPU ``generator`` to draw
        them from, in train mode; eval mode ignores both."""
        b, l = grouped.shape[:2]
        psm = self.cls_head(grouped.flatten(0, 1).to(self.compute_dtype))
        return self.fusion_net(grouped, psm.unflatten(0, (b, l)),
                               batch["agent_mask"], comm_u=comm_u,
                               generator=generator)


class PointPillarV2XViT(PointPillarBase):
    def __init__(self, args: dict):
        super().__init__(args)
        self.fusion_net = V2XTransformer(args["transformer"])

    def fuse(self, grouped, batch):
        return (self.fusion_net(grouped, batch["agent_mask"], batch["pairwise_t"],
                                batch["prior_encoding"]), _rate(1.0, grouped))


class PointPillarCoBEVT(PointPillarBase):
    """CoBEVT's swap fusion; ``agent_size`` defaults to the slot count."""

    def __init__(self, args: dict):
        super().__init__(args)
        fax = dict(args["fax_fusion"])
        fax.setdefault("agent_size", self.layout.total)
        self.fusion_net = SwapFusionEncoder(fax)

    def fuse(self, grouped, batch):
        return self.fusion_net(grouped, batch["agent_mask"]), _rate(1.0, grouped)


class PointPillarV2VNet(PointPillarBase):
    def __init__(self, args: dict):
        super().__init__(args)
        self.fusion_net = V2VNetFusion(args["v2vfusion"], self.head_in)

    def fuse(self, grouped, batch):
        return (self.fusion_net(grouped, batch["agent_mask"],
                                batch["pairwise_t_full"]), _rate(1.0, grouped))


class PointPillarWhen2com(PointPillarBase):
    """When2com's handshake. Its MLPs' input size follows the fused map's
    (H, W), which the JAX package infers from the map; the config's ``H`` /
    ``W`` are replaced by the map's own (``feature_hw``), so a grid other
    than the config's (DAIR's 504 x 200) builds the right MLPs."""

    def __init__(self, args: dict):
        super().__init__(args)
        h, w = self.feature_hw
        self.fusion_net = When2comFusion(
            dict(args["when2com_fusion"], H=h, W=w), self.head_in)

    def fuse(self, grouped, batch):
        return (self.fusion_net(grouped, batch["agent_mask"],
                                batch["pairwise_t_full"]), _rate(1.0, grouped))


class PixelWeightLayer(nn.Module):
    """1x1 convs 2C -> 128 -> 32 -> 8 -> 1, BN and ReLU between, a final
    ReLU and no final BN: one weight logit per pixel."""

    FLAX_NAMES = {"conv0": "Conv_0", "bn0": "BatchNorm_0", "conv1": "Conv_1",
                  "bn1": "BatchNorm_1", "conv2": "Conv_2", "bn2": "BatchNorm_2",
                  "conv3": "Conv_3"}

    def __init__(self, in_ch: int):
        super().__init__()
        widths = (in_ch, 128, 32, 8)
        for i in range(3):
            self.add_module(f"conv{i}", nn.Conv2d(widths[i], widths[i + 1], 1))
            self.add_module(f"bn{i}", BatchNorm2d(widths[i + 1]))
        self.conv3 = nn.Conv2d(8, 1, 1)

    def forward(self, x):
        for i in range(3):
            x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return torch.relu(self.conv3(x))


class PointPillarDiscoNet(PointPillarBase):
    """DiscoNet's student (``point_pillar_disconet``); the frozen
    early-fusion teacher supervises ``student_feature`` through
    ``point_pillar_disconet_loss`` (``tools/train_w_kd.py``)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.pixel_weight = PixelWeightLayer(2 * self.head_in)

    def fuse(self, grouped, batch):
        b, l = grouped.shape[:2]
        x = grouped.to(self.compute_dtype)
        cat = torch.cat([x, x[:, :1].expand_as(x)], dim=2)
        logits = self.pixel_weight(cat.flatten(0, 1)).unflatten(0, (b, l))
        mask = batch["agent_mask"][:, :, None, None, None].bool()
        logits = logits.masked_fill(~mask, -1e9)
        w = torch.exp(logits - logits.amax(1, keepdim=True)) * mask.to(logits.dtype)
        w = w / w.sum(1, keepdim=True).clamp_min(1e-9)
        return (grouped * w).sum(1), _rate(1.0, grouped)

    def forward(self, batch):
        fused, rate = self.fuse(self.backbone_2d(self.encode(batch)), batch)
        out = self.heads(fused)
        out["comm_rate"] = rate
        out["student_feature"] = fused.permute(0, 2, 3, 1)
        return out


class PointPillarSiCP(PointPillarBase):
    """Flat SiCP (``point_pillar_sicp``): ``SpatialFusion`` of the ego with
    each sender warped into its frame. The config puts ``in_channels`` (the
    pair's width, twice an agent's) and ``out_channels`` at the top of the
    model args (or under ``fusion``). In train mode the outputs also carry
    the ego alone through the shared heads (``psm1`` / ``rm1``) and the
    fused heads again (``psm2`` / ``rm2``) for SiCP's dual loss."""

    def __init__(self, args: dict):
        super().__init__(args)
        fcfg = args.get("fusion") or {
            k: args[k] for k in ("in_channels", "out_channels", "voxel_size",
                                 "downsample_rate") if k in args}
        self.fusion_net = SpatialFusion(int(fcfg["in_channels"]),
                                        int(fcfg["out_channels"]))
        vs = fcfg.get("voxel_size") or args["preprocess"]["args"]["voxel_size"]
        self.discrete_ratio = vs[0]
        self.downsample_rate = fcfg.get("downsample_rate", 2)

    def fuse(self, grouped, batch):
        return (self.fusion_net(grouped, batch["agent_mask"],
                                batch["pairwise_t_full"],
                                discrete_ratio=self.discrete_ratio,
                                downsample_rate=self.downsample_rate),
                _rate(1.0, grouped))

    def forward(self, batch):
        grouped = self.backbone_2d(self.encode(batch))
        fused, rate = self.fuse(grouped, batch)
        out = self.heads(fused)
        out["comm_rate"] = rate
        if self.training:
            solo = self.heads(grouped[:, 0])
            out["psm1"], out["rm1"] = solo["psm"], solo["rm"]
            out["psm2"], out["rm2"] = out["psm"], out["rm"]
        return out
