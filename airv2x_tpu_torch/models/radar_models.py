"""The V2X-R 4D-radar and LiDAR + 4D-radar models, in eval and train mode
(counterpart of airv2x_tpu/models/radar_models.py).

The batch carries a second cloud per agent, ``radar_points`` (B, L, Nr, 4)
and ``radar_points_mask`` (B, L, Nr), on the LiDAR's grid.

  * the eight ``_lrf`` twins (``make_lrf``): intermediate, v2xvit, cobevt,
    where2comm, coalign, scope, spatialcooper and sicp. A second pillar
    encoder for the radar (``FastPillarBEV``, one more K1 launch per scene,
    on the fast path; else ``PillarVFE``), the two BEV maps concatenated on
    channels and multiplied by the agent mask, then the base model's fusion
    unchanged on a backbone of twice the input width;
  * point_pillar_l4dr / point_pillar_L4DR (``PointPillarL4DR``): the LiDAR
    through the config's encoder, the radar always through the classic
    ``PillarVFE``, into the three-stream ``MGFBackbone`` with per-level
    ego attention between stage and deblock;
  * point_pillar_interf / point_pillar_InterF (``PointPillarInterF``): both
    clouds pillarized (the classic path, no PFN), each point given the
    10-dim augmentation, and ``InterRAL`` run in both directions with
    shared weights: cross-pillar attention over the sample's flat pillar
    list of every agent. Its energy is (B, K, N, N) with N = L x the pillar
    cap, so the port loops over the K point slots (each slot's attention
    is independent of the others') to hold one slot's (B, N, N) at a time;
  * RTNH_intermediate / rtnh_intermediate (``RTNHIntermediate``): the
    radar cloud (the LiDAR's where the batch has none) voxelized on the
    classic path at 4 points per voxel, a bias-free Linear and a max over
    the point slots (the zero padding rows included), the dense (Z, Y, X)
    grid through ``sparse3d.RadarSparseBackbone`` with per-level ego
    attention, two 1x1 heads; no K1, no ``ConvBNReLU``;
  * point_pillar_intermediate_lrf_MDD / point_pillar_mdd
    (``PointPillarLRFMDD``): both clouds through ``FastPillarBEV`` (two K1
    launches per scene), the LiDAR map denoised by ``fusion/mdd.py``'s
    radar-conditioned reverse chain and masked to the LiDAR map's nonzero
    entries, [denoised, radar] into the per-stage AttFusion backbone. In
    train mode it emits ``pred_feature`` and ``gt_feature`` (NHWC): the
    LiDAR cloud under the batch's clean-point mask ``de_points_mask``
    through the same encoder without a gradient (the LiDAR map itself
    where the batch has no such mask), for ``point_pillar_loss_mdd``.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.bev_backbone import BEVStage
from airv2x_tpu_torch.models.coalign_model import PointPillarCoAlign
from airv2x_tpu_torch.models.att_backbone_models import PointPillarSpatialCooper
from airv2x_tpu_torch.models.fusion.common import NEG_INF, ego_agent_attention
from airv2x_tpu_torch.models.fusion.mdd import CondDiffDenoise
from airv2x_tpu_torch.models.nn import DeconvBNReLU, MaskedBatchNorm
from airv2x_tpu_torch.models.pillar_vfe import augment_pillar_points
from airv2x_tpu_torch.models.point_pillar_models import (
    PointPillarBase, PointPillarCoBEVT, PointPillarIntermediate,
    PointPillarSiCP, PointPillarV2XViT, PointPillarWhere2comm,
    _PerStageFusionBase, _rate)
from airv2x_tpu_torch.models.scope_model import PointPillarScope
from airv2x_tpu_torch.models.sparse3d import RadarSparseBackbone
from airv2x_tpu_torch.ops.scatter import (
    scatter_pillars_to_bev_batch, scatter_voxels_to_grid_batch)
from airv2x_tpu_torch.ops.voxelize import pillar_kwargs, pillarize_batch


def encode_radar(model: PointPillarBase, batch) -> torch.Tensor:
    """The radar cloud through ``model.radar_vfe`` -> (B, L, ny, nx, C)."""
    return model.encode_cloud(batch["radar_points"], batch["radar_points_mask"],
                              model.radar_vfe)


def make_lrf(base_cls):
    """The LiDAR + radar concat twin of ``base_cls``."""

    class LRF(base_cls):
        def __init__(self, args: dict):
            super().__init__(args)
            self.radar_vfe = self.make_vfe(args)

        def backbone_in(self, args: dict) -> int:
            return 2 * super().backbone_in(args)

        def encode(self, batch):
            lidar = self.encode_cloud(batch["points"], batch["points_mask"],
                                      self.vfe)
            fused = torch.cat([lidar, encode_radar(self, batch)], dim=-1)
            return fused * batch["agent_mask"][:, :, None, None, None].to(
                fused.dtype)

    LRF.__name__ = LRF.__qualname__ = base_cls.__name__ + "LRF"
    LRF.__doc__ = f"The LiDAR + 4D-radar concat twin of {base_cls.__name__}."
    return LRF


PointPillarIntermediateLRF = make_lrf(PointPillarIntermediate)
PointPillarV2XViTLRF = make_lrf(PointPillarV2XViT)
PointPillarCoBEVTLRF = make_lrf(PointPillarCoBEVT)
PointPillarWhere2commLRF = make_lrf(PointPillarWhere2comm)
PointPillarCoAlignLRF = make_lrf(PointPillarCoAlign)
PointPillarScopeLRF = make_lrf(PointPillarScope)
PointPillarSpatialCooperLRF = make_lrf(PointPillarSpatialCooper)
PointPillarSiCPLRF = make_lrf(PointPillarSiCP)
LRF_MODELS = {"point_pillar_intermediate_lrf": PointPillarIntermediateLRF,
              "point_pillar_v2xvit_lrf": PointPillarV2XViTLRF,
              "point_pillar_cobevt_lrf": PointPillarCoBEVTLRF,
              "point_pillar_where2comm_lrf": PointPillarWhere2commLRF,
              "point_pillar_coalign_lrf": PointPillarCoAlignLRF,
              "point_pillar_scope_lrf": PointPillarScopeLRF,
              "point_pillar_spatialcooper_lrf": PointPillarSpatialCooperLRF,
              "point_pillar_sicp_lrf": PointPillarSiCPLRF}


class MGFBackbone(nn.Module):
    """Three stage stacks: the [LiDAR, radar] concat, the LiDAR alone and
    the radar alone. Each single-modality stream is gated per level by the
    sigmoid of a bias-free 3x3 conv of itself, and the gated map feeds its
    next stage. Per level the three maps go through ``fuse`` (the agent
    fusion) and their deblocks, the single-modality ones at half width; the
    ups are concatenated level by level as [concat, LiDAR, radar]."""

    def __init__(self, in_ch: int, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters):
        super().__init__()

        def stack(c):
            ins = [c] + list(num_filters[:-1])
            return nn.ModuleList(
                BEVStage(i, f, s, n) for i, f, s, n in
                zip(ins, num_filters, layer_strides, layer_nums))

        def gates():
            return nn.ModuleList(nn.Conv2d(f, f, 3, padding=1, bias=False)
                                 for f in num_filters)

        def deblocks(div):
            return nn.ModuleList(
                DeconvBNReLU(i, f // div, s) for i, f, s in
                zip(num_filters, num_upsample_filters, upsample_strides))

        self.stages, self.l_stages, self.r_stages = (
            stack(2 * in_ch), stack(in_ch), stack(in_ch))
        self.lg_convs, self.rg_convs = gates(), gates()
        self.deblocks, self.l_deblocks, self.r_deblocks = (
            deblocks(1), deblocks(2), deblocks(2))
        self.out_channels = sum(int(f) + 2 * (int(f) // 2)
                                for f in num_upsample_filters)

    def forward(self, x, lx, rx, fuse):
        """x (B*L, 2C, H, W), lx / rx (B*L, C, H, W); ``fuse`` maps a level
        (B*L, C', h, w) to the fused (B, C', h, w)."""
        ups = []
        for i in range(len(self.stages)):
            x = self.stages[i](x)
            lx = self.l_stages[i](lx)
            rx = self.r_stages[i](rx)
            lx = torch.sigmoid(self.lg_convs[i](lx)) * lx
            rx = torch.sigmoid(self.rg_convs[i](rx)) * rx
            ups += [self.deblocks[i](fuse(x)), self.l_deblocks[i](fuse(lx)),
                    self.r_deblocks[i](fuse(rx))]
        return torch.cat(ups, dim=1)


class PointPillarL4DR(PointPillarBase):
    """L4DR: the MGF backbone over the LiDAR and radar maps; the heads on
    the shrunk pyramid (comm_rate 1)."""

    def __init__(self, args: dict):
        super().__init__(args)
        del self.backbone  # the MGF backbone takes its place
        self.radar_vfe = self.make_vfe(args, classic=True)
        bb = args["base_bev_backbone"]
        self.mgf = MGFBackbone(self.vfe.out_c, bb["layer_nums"],
                               bb["layer_strides"], bb["num_filters"],
                               bb["upsample_strides"], bb["num_upsample_filter"])
        self.build_heads(args, self.mgf.out_channels)

    def forward(self, batch):
        lidar = self.encode_cloud(batch["points"], batch["points_mask"], self.vfe)
        radar = encode_radar(self, batch)
        b, l = lidar.shape[:2]

        def flat(t):
            return t.flatten(0, 1).permute(0, 3, 1, 2).to(self.compute_dtype)

        def fuse(f):
            return ego_agent_attention(f.unflatten(0, (b, l)),
                                       batch["agent_mask"])

        lid, rad = flat(lidar), flat(radar)
        feats = self.mgf(torch.cat([lid, rad], dim=1), lid, rad, fuse)
        if self.shrink_conv is not None:
            feats = self.shrink_conv(feats)
        out = self.heads(feats)
        out["comm_rate"] = _rate(1.0, feats)
        return out


class InterRAL(nn.Module):
    """Cross-pillar attention: for each point slot k, every pillar row of x
    attends over every pillar row of y (one shared q / k projection); the
    softmax over y rows is renormalised over the real x rows; the residual
    runs trans_conv, a BatchNorm over the real rows and ReLU; the output is
    the max over the point slots, padding slots included. Padded pillar
    rows take no part in the attention or the BN statistics."""

    FLAX_NAMES = {"bn": "MaskedBatchNorm_0"}

    def __init__(self, in_c: int, channels: int):
        super().__init__()
        self.shared_linear = nn.Linear(in_c, channels)
        self.qk_conv = nn.Linear(channels, channels // 16, bias=False)
        self.v_conv = nn.Linear(channels, channels)
        self.trans_conv = nn.Linear(channels, channels)
        self.bn = MaskedBatchNorm(channels)

    def forward(self, x_aug, y_aug, x_rowmask, y_rowmask):
        """x_aug (B, N, K, F), y_aug (B, M, K, F) augmented points; row
        masks (B, N) / (B, M) -> (B, N, channels)."""
        dt = self.shared_linear.weight.dtype
        x = self.shared_linear(x_aug.to(dt))
        y = self.shared_linear(y_aug.to(dt))
        q, k, v = self.qk_conv(x), self.qk_conv(y), self.v_conv(y)
        ym = y_rowmask[:, None, :]
        xm = x_rowmask[:, :, None].to(dt)
        y_r = []
        for s in range(x.shape[2]):  # one point slot's (B, N, M) at a time
            energy = torch.einsum("bnc,bmc->bnm", q[:, :, s], k[:, :, s])
            energy = energy.masked_fill(~ym, NEG_INF)
            attn = torch.softmax(energy, dim=-1) * xm * ym.to(dt)
            attn = attn / (1e-9 + attn.sum(dim=1, keepdim=True))
            y_r.append(torch.einsum("bnm,bmc->bnc", attn, v[:, :, s]))
        t = self.trans_conv(x - torch.stack(y_r, dim=2))
        bn_mask = x_rowmask[:, :, None].expand(t.shape[:-1])
        x = x + torch.relu(self.bn(t, bn_mask))
        return x.amax(dim=-2)


class PointPillarInterF(_PerStageFusionBase):
    """InterFusion: ``InterRAL`` in both directions over the LiDAR and radar
    pillars, each direction scattered to its own canvas, the two concatenated
    into the per-stage AttFusion backbone. No VFE: the attention consumes
    the augmented points themselves."""

    _force_classic_vfe = True

    def __init__(self, args: dict):
        super().__init__(args)
        del self.vfe
        self.inter_ral = InterRAL(10, int(args.get("interral_channels", 64)))

    def backbone_in(self, args: dict) -> int:
        return 2 * int(args.get("interral_channels", 64))

    def encode(self, batch):
        kw = self.pillar_kw
        pts = batch["points"]
        b, l = pts.shape[:2]
        dt = self.inter_ral.shared_linear.weight.dtype

        def pillars(points, mask):
            pil = pillarize_batch(points.flatten(0, 1), mask.flatten(0, 1), **kw)
            aug, _ = augment_pillar_points(
                pil.voxels, pil.num_points, pil.coords,
                voxel_size=kw["voxel_size"], lidar_range=kw["lidar_range"],
                dtype=dt)
            # the sample's flat pillar list spans all its agents
            return (pil, aug.reshape((b, -1) + aug.shape[2:]),
                    pil.mask.reshape(b, -1))

        pl, xf, xm = pillars(batch["points"], batch["points_mask"])
        pr, yf, ym = pillars(batch["radar_points"], batch["radar_points_mask"])
        bev = []
        for pil, feats in ((pl, self.inter_ral(xf, yf, xm, ym)),
                           (pr, self.inter_ral(yf, xf, ym, xm))):
            feats = feats.reshape(b * l, -1, feats.shape[-1])
            feats = feats * pil.mask[..., None].to(feats.dtype)
            bev.append(scatter_pillars_to_bev_batch(
                feats, pil.coords, pil.mask, ny=self.grid[1], nx=self.grid[0]))
        out = torch.cat(bev, dim=-1).unflatten(0, (b, l))
        return out * batch["agent_mask"][:, :, None, None, None].to(out.dtype)


class RTNHIntermediate(nn.Module):
    """RTNH: radar voxels through the masked dense 3-D backbone, the levels
    fused by ego attention per agent slot, two 1x1 heads (comm_rate 1).
    The YAML has no ``BACKBONE`` block, so the code's defaults hold:
    encoder 64 / 128 / 256 at stride 2, BEV 256 x 3 from transposed convs
    of kernels 3 / 6 / 12 at strides 1 / 2 / 4."""

    FLAX_NAMES = {"cls_head": "conv_cls", "reg_head": "conv_reg"}
    POINTS_PER_VOXEL = 4  # RTNH's PointToVoxel cap

    def __init__(self, args: dict):
        super().__init__()
        max_cav = args.get("max_cav", 5)
        if isinstance(max_cav, dict):
            max_cav = sum(max_cav.values())
        self.layout = SlotLayout(counts=(int(max_cav), 0, 0))
        self.pillar_kw = dict(pillar_kwargs(args["preprocess"]),
                              max_points_per_pillar=self.POINTS_PER_VOXEL)
        self.grid = self.pillar_kw["grid_size"]  # (nx, ny, nz)
        bb = dict(args.get("BACKBONE") or {})
        enc, bev = dict(bb.get("ENCODING") or {}), dict(bb.get("TO_BEV") or {})
        out_dim = int(args.get("PRE_PROCESSOR", {}).get("OUT_DIM", 64))
        self.simplified_pointnet = nn.Linear(4, out_dim, bias=False)
        self.backbone = RadarSparseBackbone(
            out_dim,
            enc_channels=enc.get("CHANNEL", (64, 128, 256)),
            enc_strides=enc.get("STRIDE", (2, 2, 2)),
            enc_paddings=enc.get("PADDING", (1, 1, 1)),
            bev_channels=bev.get("CHANNEL", (256, 256, 256)),
            bev_kernels=bev.get("KERNEL_SIZE", (3, 6, 12)),
            bev_strides=bev.get("STRIDE", (1, 2, 4)),
            bev_paddings=bev.get("PADDING", (1, 2, 4)),
            z_shape=self.grid[2])
        anchors = int(args.get("anchor_num", args.get("anchor_number", 2)))
        self.cls_head = nn.Conv2d(self.backbone.out_channels, anchors, 1)
        self.reg_head = nn.Conv2d(self.backbone.out_channels, 7 * anchors, 1)

    def forward(self, batch):
        pts = batch.get("radar_points")
        mask = batch.get("radar_points_mask")
        if pts is None:
            pts, mask = batch["points"], batch["points_mask"]
        b, l = pts.shape[:2]
        pil = pillarize_batch(pts.flatten(0, 1), mask.flatten(0, 1),
                              **self.pillar_kw)
        dt = self.simplified_pointnet.weight.dtype
        slot = torch.arange(pil.voxels.shape[-2], device=pts.device)
        live = slot < pil.num_points[..., None]
        vox = torch.where(live[..., None], pil.voxels.to(dt),
                          torch.zeros((), dtype=dt, device=pts.device))
        vf = self.simplified_pointnet(vox).amax(-2)
        vf = vf * pil.mask[..., None].to(vf.dtype)
        nx, ny, nz = self.grid
        dense = scatter_voxels_to_grid_batch(vf, pil.coords, pil.mask, nz=nz,
                                             ny=ny, nx=nx)
        occ = scatter_voxels_to_grid_batch(
            pil.mask[..., None].to(torch.uint8), pil.coords, pil.mask, nz=nz,
            ny=ny, nx=nx)[..., 0] > 0
        am = batch["agent_mask"]
        occ = occ & am.reshape(b * l)[:, None, None, None]

        def fuse(f):
            return ego_agent_attention(f.unflatten(0, (b, l)), am)

        bev = self.backbone(dense.permute(0, 4, 1, 2, 3), occ, fuse)
        out = {"psm": self.cls_head(bev).permute(0, 2, 3, 1),
               "rm": self.reg_head(bev).permute(0, 2, 3, 1)}
        out["comm_rate"] = _rate(1.0, bev)
        return out


class PointPillarLRFMDD(_PerStageFusionBase):
    """LiDAR + radar with the MDD denoiser (comm_rate 1): both clouds
    through the config's pillar encoder, the LiDAR map denoised and
    masked, [denoised, radar] through the backbone's stages with per-stage
    ego attention before each deblock. In training the train step passes
    its per-step CPU ``generator``, from which the chain's noise is seeded."""

    DRAWS_NOISE = True

    def __init__(self, args: dict):
        super().__init__(args)
        self.radar_vfe = self.make_vfe(args)
        mdd = args["mdd_block"]
        self.mdd = CondDiffDenoise(
            mdd["model"], int(mdd["diffusion"]["num_diffusion_timesteps"]))

    def backbone_in(self, args: dict) -> int:
        return 2 * super().backbone_in(args)

    def forward(self, batch, generator=None):
        lidar = self.encode_cloud(batch["points"], batch["points_mask"], self.vfe)
        radar = encode_radar(self, batch)
        b, l = lidar.shape[:2]
        lid = lidar.flatten(0, 1).permute(0, 3, 1, 2)
        rad = radar.flatten(0, 1).permute(0, 3, 1, 2)
        pred = self.mdd(lid, rad, batch.get("mdd_noises"), generator)
        pred = pred * (lid != 0).to(pred.dtype)
        out = {"pred_feature": pred.permute(0, 2, 3, 1)}
        if self.training:
            de_mask = batch.get("de_points_mask")
            if de_mask is None:
                gt = lidar.flatten(0, 1)
            else:
                with torch.no_grad():
                    gt = self.encode_cloud(batch.get("de_points", batch["points"]),
                                           de_mask, self.vfe).flatten(0, 1)
            out["gt_feature"] = gt.detach()
        dt = self.compute_dtype
        h = torch.cat([pred.to(dt), rad.to(dt)], dim=1)
        ups = []
        for i in range(len(self.backbone.stages)):
            h = self.backbone.stage(i, h)
            fused = self._fuse_scale(h.unflatten(0, (b, l)), batch["agent_mask"])
            ups.append(self.backbone.deblock(i, fused))
        fused = self.backbone.finish(ups)
        if self.shrink_conv is not None:
            fused = self.shrink_conv(fused)
        out.update(self.heads(fused))
        out["comm_rate"] = _rate(1.0, fused)
        return out
