"""Heterogeneous multi-agent base: slot layout + per-type LiDAR encoders
(counterpart of airv2x_tpu/models/base.py, fast pillar branch only).

Every sample carries a statically laid-out agent axis:

    slot 0 .. V-1   : vehicles (ego is always slot 0)
    slot V .. V+R-1 : road-side units
    slot V+R .. L-1 : drones

with a boolean ``agent_mask`` for absent agents. Each agent type has its own
encoder weights and its own z-extent for the cell-centre offsets, on the
shared ego grid.

Batch contract: points (B, L, N, 4) f32 ego frame, points_mask (B, L, N)
bool, agent_mask (B, L) bool.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV

AGENT_TYPES = ("vehicle", "rsu", "drone")


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Static agent-slot layout derived from the config's max_cav."""

    counts: tuple  # (n_vehicle, n_rsu, n_drone); zero for absent types

    @classmethod
    def from_args(cls, args: dict) -> "SlotLayout":
        max_cav = args["max_cav"]
        collab = args.get("collaborators", list(AGENT_TYPES))
        counts = tuple(
            int(max_cav.get(t, 0)) if t in collab else 0 for t in AGENT_TYPES
        )
        return cls(counts=counts)

    @property
    def total(self) -> int:
        return sum(self.counts)

    def slots(self, agent_type: str) -> slice:
        i = AGENT_TYPES.index(agent_type)
        start = sum(self.counts[:i])
        return slice(start, start + self.counts[i])


class HeteroLidarEncoder(nn.Module):
    """Per-type FastPillarBEV on the shared ego grid -> (B, L, ny, nx, C).

    One FastPillarBEV call (one K1 launch) per present agent type; the
    submodules are named ``<type>_pillar_vfe`` as the flax scopes are.
    """

    def __init__(self, args: dict, preprocess: dict, layout: SlotLayout):
        super().__init__()
        self.layout = layout
        lidar_range = preprocess["cav_lidar_range"]
        voxel_size = preprocess["args"]["voxel_size"]
        if not preprocess["args"].get("fast_pillars", True):
            raise NotImplementedError("the classic voxel path is not ported")
        self.types = []
        for t in AGENT_TYPES:
            if not layout.counts[AGENT_TYPES.index(t)]:
                continue
            if args[t].get("modalities", ["lidar"]) != ["lidar"]:
                raise NotImplementedError(f"{t}: only the LiDAR modality is ported")
            cfg = args[t]["lidar"]
            vfe = cfg["pillar_vfe"]
            self.add_module(f"{t}_pillar_vfe", FastPillarBEV(
                num_filters=vfe["num_filters"],
                voxel_size=voxel_size,
                lidar_range=lidar_range,
                use_norm=vfe["use_norm"],
                with_distance=vfe["with_distance"],
                use_absolute_xyz=vfe["use_absolute_xyz"],
                offset_voxel_size=cfg["voxel_size"],
                offset_lidar_range=cfg["lidar_range"],
            ))
            self.types.append(t)
        widths = {self.get_submodule(f"{t}_pillar_vfe").out_c for t in self.types}
        if len(widths) != 1:
            raise ValueError(f"agent types disagree on the BEV width: {widths}")
        self.out_channels = widths.pop()

    def forward(self, batch):
        pts, pmask = batch["points"], batch["points_mask"]
        feats = [
            self.get_submodule(f"{t}_pillar_vfe")(
                pts[:, self.layout.slots(t)], pmask[:, self.layout.slots(t)]
            )
            for t in self.types
        ]
        x = torch.cat(feats, dim=1)  # (B, L, ny, nx, C)
        # zero the padding agents' features
        return x * batch["agent_mask"][:, :, None, None, None].to(x.dtype)
