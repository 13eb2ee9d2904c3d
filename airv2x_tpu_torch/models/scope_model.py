"""SCOPE, in eval and train mode (counterpart of
airv2x_tpu/models/scope_model.py: ``PointPillarScope``): temporal,
collaborative and late fusion on the ``PointPillarBase`` spine. In train
mode the encoder takes its plain scatter path, every BatchNorm updates its
statistics at its JAX momentum (the backbone's 0.99, the temporal LSTM's
0.9), and the gradients flow through the warps and the deformable
sampling; the train step's loss reads psm / rm.

Temporal batch contract: every per-frame array carries a time axis after
the batch axis, the LAST frame is the current one: points (B, T, L, N, 4),
points_mask (B, T, L, N), agent_mask (B, T, L), pairwise_t_full
(B, T, L, L, 4, 4); history_t (B, T, 4, 4) is each frame's ego pose in the
current ego frame.

Stages (``STAGES``; ``forward(batch, mark)`` calls ``mark(name)`` at the
end of each):

  1. every frame through the shared pillar encoder (one K1 launch per
     frame over the B * L clouds), backbone and shrink;
  2. temporal: each frame's ego map warped into the current ego frame by
     ``history_t``, then ``TemporalFusionLSTM`` -> the temporal map;
  3. collaboration over the current frame: the single-agent heads, the comm
     masks (applied at level 0), the backbone's stages rerun on the raw BEV
     features, each level's non-ego slots warped into the ego frame by
     the ego row of ``pairwise_t_full``, fused per level (Deform, MAX or
     ATTEN), through its deblock, concatenated and shrunk;
  4. late fusion of the temporal, ego and collaborative maps, and the heads.

The collaboration's normalized affine uses the pillar grid's size at every
level (the normalized coordinates do not depend on the resolution); the
history warp uses the 2-D map's, with the map's stride over the grid. The
deform confidence maps are not warped: each level takes every 2^i-th cell
of the level-0 maps. SCOPE runs the backbone's stages twice on the current
frame (stages 1 and 3), as the JAX package does.

Outputs, NHWC as the JAX package's: psm (B, H, W, A), rm (B, H, W, 7A), the
scalar comm_rate, and the ego's (and slot 1's) single-agent heads
psm_single_v / rm_single_v (psm_single_i / rm_single_i).
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.msda import DeformableQueryRefine
from airv2x_tpu_torch.models.fusion.scope import (
    ScopeCommunication, ScopeLateFusion, TemporalFusionLSTM, atten_fusion,
    max_fusion)
from airv2x_tpu_torch.models.fusion.temporal import warp_history_to_current
from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)

AGG_MODES = ("Deform", "MAX", "ATTEN")


def _no_mark(name):
    """The ``mark`` of an untimed run."""


class PointPillarScope(PointPillarBase):
    FLAX_NAMES = {"fuse_modules": "deform_fuse"}
    STAGES = ("encoder+backbone+shrink", "temporal", "collaboration",
              "late fusion+heads")

    def __init__(self, args: dict):
        super().__init__(args)
        fa = args["fusion_args"]
        comm = fa.get("communication")
        gs = (comm or {}).get("gaussian_smooth", {"k_size": 5, "c_sigma": 1.0})
        k_size, c_sigma = int(gs.get("k_size", 5)), float(gs.get("c_sigma", 1.0))
        thre = float((comm or {}).get("thre", 0.01))
        self.agg_mode = str((fa.get("agg_operator") or {}).get("mode", "ATTEN"))
        if self.agg_mode not in AGG_MODES:
            raise ValueError(f"unknown agg_operator mode {self.agg_mode!r}")
        self.discrete_ratio = float(fa["voxel_size"][0])
        self.downsample_rate = float(fa.get("downsample_rate", 1))
        self.naive_communication = (ScopeCommunication(thre, k_size, c_sigma)
                                    if comm is not None else None)
        self.fuse_modules = nn.ModuleList()
        if self.agg_mode == "Deform":
            self.fuse_modules.extend(
                DeformableQueryRefine(int(f), n_points=9,
                                      num_queries=int(fa.get("num_queries", 500)),
                                      max_cav=self.layout.total)
                for f in fa.get("num_filters", []))
        tf = fa["temporal_fusion"]
        self.temporal_fusion = TemporalFusionLSTM(
            int(tf["channel"]), int(tf["height"]), int(tf["width"]))
        self.late_fusion = ScopeLateFusion(k_size, c_sigma)

    @staticmethod
    def _frame(batch, i):
        """Frame i's batch. A radar cloud is sliced ``[:, i]`` as the JAX
        package slices it: the datasets give the current frame's radar only
        (no time axis), so there the slice takes agent i's cloud, which no
        model but a ``_lrf`` twin reads."""
        keys = ("points", "points_mask", "agent_mask", "radar_points",
                "radar_points_mask")
        return {k: batch[k][:, i] for k in keys if k in batch}

    def frame_features(self, batch):
        """Stage 1: per frame (BEV features (B, L, ny, nx, C), backbone +
        shrink maps (B, L, C', H, W))."""
        frames = []
        for i in range(batch["points"].shape[1]):
            spatial = self.encode(self._frame(batch, i))
            frames.append((spatial, self.backbone_2d(spatial)))
        return frames

    def temporal(self, frames, batch):
        """Stage 2: the ego maps of every frame, current first, warped into
        the current frame and fused -> (temporal map (B, C', H, W), its
        cls logits)."""
        t = len(frames)
        spatial, cur_2d = frames[-1]
        hist = torch.stack([frames[t - 1 - k][1][:, 0] for k in range(t)], 1)
        hist_t = torch.stack([batch["history_t"][:, t - 1 - k]
                              for k in range(t)], 1)
        stride = spatial.shape[2] // cur_2d.shape[-2]
        hist = warp_history_to_current(
            hist.permute(0, 1, 3, 4, 2), hist_t, self.discrete_ratio,
            self.downsample_rate * stride).permute(0, 1, 4, 2, 3)
        out = self.temporal_fusion(hist)
        return out, self.cls_head(out)

    def collaborate(self, frames, batch):
        """Stage 3 over the current frame -> (fused map (B, C', H, W), its
        cls logits, single-agent psm (B, L, A, H, W) and rm, comm rate)."""
        spatial, cur_2d = frames[-1]
        b, l, ny, nx, c = spatial.shape
        flat_2d = cur_2d.flatten(0, 1)
        psm_slots = self.cls_head(flat_2d).unflatten(0, (b, l))
        rm_slots = self.reg_head(flat_2d).unflatten(0, (b, l))
        agent_mask = batch["agent_mask"][:, -1]
        if batch["pairwise_t_full"].dim() != 6:
            raise ValueError(
                "SCOPE reads pairwise_t_full as (B, T, L, L, 4, 4), got "
                f"{tuple(batch['pairwise_t_full'].shape)}: repeat a loaded "
                "batch's over the frames (data/opv2v_dataset.py:"
                "pairwise_over_frames)")
        aff = normalized_pairwise_affine(
            batch["pairwise_t_full"][:, -1, 0], ny, nx, self.discrete_ratio,
            self.downsample_rate)  # (B, L, 2, 3): each slot into the ego's
        mask5 = agent_mask[:, :, None, None, None].to(spatial.dtype)
        rate = torch.zeros((), dtype=torch.float32, device=spatial.device)
        if self.naive_communication is not None:
            comm_masks, rate, deform_map = self.naive_communication(
                psm_slots, agent_mask)

        x = spatial.reshape(b * l, ny, nx, c).permute(0, 3, 1, 2)
        dt = self.compute_dtype
        ups = []
        for i, stage in enumerate(self.backbone.stages):
            x = stage(x)
            xi = x.unflatten(0, (b, l))
            if i == 0 and self.naive_communication is not None:
                xi = xi * comm_masks[:, :, None]
            xi = xi.permute(0, 1, 3, 4, 2)  # channels-last
            warped = warp_affine_normalized(xi[:, 1:], aff[:, 1:])
            xi = torch.cat([xi[:, :1], warped], dim=1) * mask5
            if self.agg_mode == "Deform":
                s = 2 ** i
                fused = self.fuse_modules[i](xi, deform_map[:, :, ::s, ::s])
            elif self.agg_mode == "MAX":
                fused = max_fusion(xi)
            else:
                fused = atten_fusion(xi, agent_mask)
            ups.append(self.backbone.deblocks[i](fused.permute(0, 3, 1, 2).to(dt)))
        x_fuse = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if self.shrink_conv is not None:
            x_fuse = self.shrink_conv(x_fuse)
        return x_fuse, self.cls_head(x_fuse), psm_slots, rm_slots, rate

    def late_heads(self, temporal, psm_temporal, cur_2d, collab):
        """Stage 4: the late blend of the temporal, ego and collaborative
        maps, and the heads -> the outputs."""
        x_fuse, psm_cross, psm_slots, rm_slots, rate = collab
        final = self.late_fusion([temporal, cur_2d[:, 0], x_fuse],
                                 psm_temporal, psm_slots[:, 0], psm_cross)
        out = {"psm": self.cls_head(final), "rm": self.reg_head(final),
               "psm_single_v": psm_slots[:, 0], "rm_single_v": rm_slots[:, 0]}
        if psm_slots.shape[1] > 1:
            out["psm_single_i"] = psm_slots[:, 1]
            out["rm_single_i"] = rm_slots[:, 1]
        out = {k: v.permute(0, 2, 3, 1) for k, v in out.items()}
        out["comm_rate"] = rate
        return out

    def forward(self, batch, mark=None):
        mark = mark or _no_mark
        frames = self.frame_features(batch)
        mark(self.STAGES[0])
        temporal, psm_temporal = self.temporal(frames, batch)
        mark(self.STAGES[1])
        collab = self.collaborate(frames, batch)
        mark(self.STAGES[2])
        out = self.late_heads(temporal, psm_temporal, frames[-1][1], collab)
        mark(self.STAGES[3])
        return out
