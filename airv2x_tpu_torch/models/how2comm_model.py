"""How2comm, in eval and train mode (counterpart of
airv2x_tpu/models/how2comm_model.py: ``PointPillarHow2comm``).

Temporal batch contract (SCOPE's): every per-frame array carries a time
axis after the batch axis, the LAST frame is the current one and ``delay``
frames back (clamped to the first) the transmitted history: points
(B, T, L, N, 4), points_mask (B, T, L, N), agent_mask (B, T, L),
pairwise_t_full (B, T, L, L, 4, 4), of which the current frame's ego row
is read (a loaded batch's (B, L, L, 4, 4) is refused, as the JAX model
fails on it: ``data/opv2v_dataset.py:pairwise_over_frames`` repeats it).

Forward:
  1. the current and the history frame through the shared pillar encoder
     (one K1 launch each);
  2. the current maps through the backbone and shrink -> the single-agent
     cls logits;
  3. with ``flow_flag`` each collaborator's current map re-estimated from
     its history by ``FlowGenerator`` (the ego keeps its own);
  4. the single-agent confidence maps, warped into the ego frame;
  5. the backbone's stages over the (flow-compensated) current and the
     history maps; per level the slot maps and history warped into the ego
     frame; at level 0 with ``communication_flag`` the mutual
     communication's sparse maps and the 7x7 ``channel_fuse``; STCFormer,
     the level's deblock; the levels concatenated and shrunk -> the heads.

Both reference quirks stay: the sparse "history" of level 0 takes the
sparse *current* collaborator maps with the ego's history, and the level-0
sparsification does not reach deeper levels (each level reads the stages'
own outputs). Outputs: psm / rm (NHWC), comm_rate, offset_loss and
commu_loss.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.how2comm import (
    FlowGenerator, MutualCommunication, confidence_maps, conv_cl)
from airv2x_tpu_torch.models.fusion.stcformer import STCFormer
from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


class PointPillarHow2comm(PointPillarBase):
    FLAX_NAMES = {"fuse_modules": "stcformer"}

    def __init__(self, args: dict):
        super().__init__(args)
        fa = dict(args["fusion_args"])
        comm = dict(fa.get("communication", {}))
        gs = dict(comm.get("gaussian_smooth", {"k_size": 5, "c_sigma": 1.0}))
        self.k_size = int(gs.get("k_size", 5))
        self.c_sigma = float(gs.get("c_sigma", 1.0))
        self.flow_flag = bool(args.get("flow_flag", True))
        self.comm_flag = bool(fa.get("communication_flag", True))
        self.delay = int(args.get("delay", 1))
        self.discrete_ratio = float(fa["voxel_size"][0])
        self.downsample_rate = float(fa.get("downsample_rate", 1))
        scatter = args.get("point_pillar_scatter") or {}
        ch0 = int(scatter.get("num_features", args["pillar_vfe"]["num_filters"][-1]))
        if self.flow_flag:
            self.flow = FlowGenerator(dict(args["base_bev_backbone"]), ch0)
        if self.comm_flag:
            self.commu_module = MutualCommunication(
                ch0, float(comm.get("thre", 0.01)),
                request_flag=bool(comm.get("request_flag", True)),
                k_size=self.k_size, c_sigma=self.c_sigma)
            self.channel_fuse = nn.Conv2d(ch0, ch0, 7, padding=3)
        nq = int(fa.get("num_queries", 500))
        self.fuse_modules = nn.ModuleList(
            STCFormer(int(f), i, num_queries=nq, max_cav=self.layout.total)
            for i, f in enumerate(fa["num_filters"]))

    def forward(self, batch):
        if batch["pairwise_t_full"].dim() != 6:
            raise ValueError(
                "How2comm reads pairwise_t_full as (B, T, L, L, 4, 4), got "
                f"{tuple(batch['pairwise_t_full'].shape)}: repeat a loaded "
                "batch's over the frames (data/opv2v_dataset.py:"
                "pairwise_over_frames)")
        t = batch["points"].shape[1]

        def frame(i):
            return self.encode({k: batch[k][:, i] for k in
                                ("points", "points_mask", "agent_mask")})

        cur = frame(t - 1)  # (B, L, ny, nx, C)
        hist = frame(max(t - 1 - self.delay, 0))
        b, l, h0, w0, c = cur.shape
        agent_mask = batch["agent_mask"][:, -1]
        psm_single = self.cls_head(
            self.backbone_2d(cur).flatten(0, 1).to(self.compute_dtype))
        if self.flow_flag:
            x, offset_loss = self.flow(cur, hist, agent_mask)
        else:
            x, offset_loss = cur, torch.zeros((), device=cur.device)
        aff = normalized_pairwise_affine(
            batch["pairwise_t_full"][:, -1], h0, w0, self.discrete_ratio,
            self.downsample_rate)[:, 0]  # (B, L, 2, 3): slot j -> ego
        mask5 = agent_mask[:, :, None, None, None]

        def warp_slots(v):
            warped = warp_affine_normalized(v[:, 1:], aff[:, 1:])
            out = torch.cat([v[:, :1], warped], dim=1)
            return out * mask5.to(out.dtype)

        def level_feats(v):
            y = v.reshape(b * l, h0, w0, c).permute(0, 3, 1, 2)
            feats = []
            for stage in self.backbone.stages:
                y = stage(y.to(self.compute_dtype))
                feats.append(y.unflatten(0, (b, l)).permute(0, 1, 3, 4, 2))
            return feats

        x_levels, his_levels = level_feats(x), level_feats(hist)
        conf = warp_slots(confidence_maps(
            psm_single.unflatten(0, (b, l)).permute(0, 1, 3, 4, 2),
            self.k_size, self.c_sigma))
        comm_rate = torch.zeros((), device=cur.device)
        commu_loss = torch.zeros((), device=cur.device)
        ups = []
        for i, fuse in enumerate(self.fuse_modules):
            xi, hisi = warp_slots(x_levels[i]), warp_slots(his_levels[i])
            if i == 0 and self.comm_flag:
                sparse, commu_loss, comm_rate, _ = self.commu_module(xi, agent_mask)
                sparse_hist = torch.cat([hisi[:, :1], sparse[:, 1:]], dim=1)
                xi = conv_cl(self.channel_fuse, sparse.flatten(0, 1)).unflatten(
                    0, (b, l))
                hisi = conv_cl(self.channel_fuse, sparse_hist.flatten(0, 1)
                               ).unflatten(0, (b, l))
            fused, _ = fuse(xi, conf, hisi, agent_mask)
            deblock = self.backbone.deblocks[i]
            ups.append(deblock(fused.permute(0, 3, 1, 2).to(deblock.deconv.weight.dtype)))
        x_fuse = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if self.shrink_conv is not None:
            x_fuse = self.shrink_conv(x_fuse)
        out = self.heads(x_fuse)
        out.update(comm_rate=comm_rate.float(), offset_loss=offset_loss,
                   commu_loss=commu_loss)
        return out
