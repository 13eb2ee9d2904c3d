"""Heterogeneous multi-agent base: slot layout + per-type LiDAR and camera
encoders (counterpart of airv2x_tpu/models/base.py: the fast and the
classic pillar branches and the LSS camera branch).

Every sample carries a statically laid-out agent axis:

    slot 0 .. V-1   : vehicles (ego is always slot 0)
    slot V .. V+R-1 : road-side units
    slot V+R .. L-1 : drones

with a boolean ``agent_mask`` for absent agents. Each agent type has its own
encoder weights and its own z-extent for the cell-centre offsets, on the
shared ego grid.

Batch contract: points (B, L, N, 4) f32 ego frame, points_mask (B, L, N)
bool, agent_mask (B, L) bool; for a type with the camera modality,
``cam_<type>`` holds imgs (B, L, Ncam, H, W, 3[+1]), intrinsics / rots /
post_rots (B, L, Ncam, 3, 3) and trans / post_trans (B, L, Ncam, 3).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from airv2x_tpu_torch.models.camera.lss import LSSCameraEncoder
from airv2x_tpu_torch.models.pillar_vfe import PillarVFE, pillar_bev
from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV
from airv2x_tpu_torch.ops.voxelize import Pillars, pillar_kwargs, pillarize_batch

AGENT_TYPES = ("vehicle", "rsu", "drone")


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """Static agent-slot layout derived from the config's max_cav."""

    counts: tuple  # (n_vehicle, n_rsu, n_drone); zero for absent types

    @classmethod
    def from_args(cls, args: dict) -> "SlotLayout":
        max_cav = args["max_cav"]
        if not isinstance(max_cav, dict):  # OPV2V's scalar: all vehicles
            return cls(counts=(int(max_cav), 0, 0))
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
    """Per-type LiDAR and camera encoders on the shared ego grid ->
    (B, L, ny, nx, C).

    A type with the ``lidar`` modality gets a FastPillarBEV (one K1 launch
    per call) or, where a type has more than one PFN layer or the config
    sets ``fast_pillars: false``, the classic path (one pillarization of
    every cloud, the type's PillarVFE, the scatter); one with ``cam`` an
    LSSCameraEncoder; a type with both takes
    the mean of the two BEV maps, and no pillar module is built for a type
    without LiDAR. The submodules are named ``<type>_pillar_vfe`` and
    ``<type>_lss`` as the flax scopes are.
    """

    def __init__(self, args: dict, preprocess: dict, layout: SlotLayout):
        super().__init__()
        self.layout = layout
        lidar_range = preprocess["cav_lidar_range"]
        voxel_size = preprocess["args"]["voxel_size"]
        self.pillar_kw = pillar_kwargs(preprocess)
        self.grid = self.pillar_kw["grid_size"]
        lidar_types = [t for t in AGENT_TYPES
                       if layout.counts[AGENT_TYPES.index(t)]
                       and "lidar" in args[t].get("modalities", ["lidar"])]
        # the sort-free encoder when every LiDAR type has one PFN layer, as
        # in the JAX package; else the classic voxel path for all of them
        self.fast = bool(preprocess["args"].get("fast_pillars", True)) and all(
            len(args[t]["lidar"]["pillar_vfe"]["num_filters"]) == 1
            for t in lidar_types)
        self.types = []
        widths = set()
        for t in AGENT_TYPES:
            if not layout.counts[AGENT_TYPES.index(t)]:
                continue
            modalities = args[t].get("modalities", ["lidar"])
            if set(modalities) - {"lidar", "cam"}:
                raise NotImplementedError(
                    f"{t}: only the LiDAR and camera modalities are ported")
            if "lidar" in modalities:
                cfg = args[t]["lidar"]
                vfe = cfg["pillar_vfe"]
                if self.fast:
                    module = FastPillarBEV(
                        num_filters=vfe["num_filters"],
                        voxel_size=voxel_size,
                        lidar_range=lidar_range,
                        use_norm=vfe["use_norm"],
                        with_distance=vfe["with_distance"],
                        use_absolute_xyz=vfe["use_absolute_xyz"],
                        offset_voxel_size=cfg["voxel_size"],
                        offset_lidar_range=cfg["lidar_range"],
                    )
                else:  # the type's own constants for the cell-centre offsets
                    module = PillarVFE(
                        num_filters=vfe["num_filters"],
                        voxel_size=cfg["voxel_size"],
                        lidar_range=cfg["lidar_range"],
                        use_norm=vfe["use_norm"],
                        with_distance=vfe["with_distance"],
                        use_absolute_xyz=vfe["use_absolute_xyz"],
                    )
                self.add_module(f"{t}_pillar_vfe", module)
                widths.add(module.out_c)
            if "cam" in modalities:
                self.add_module(f"{t}_lss", LSSCameraEncoder(args[t]["cam"]))
                widths.add(self.get_submodule(f"{t}_lss").out_channels)
            self.types.append((t, modalities))
        if len(widths) != 1:
            raise ValueError(f"agent types disagree on the BEV width: {widths}")
        self.out_channels = widths.pop()

    def forward(self, batch, mark=None):
        """``mark`` goes to the camera encoders (their stage boundaries)."""
        pil = None
        if not self.fast and any("lidar" in m for _, m in self.types):
            # one pillarization of every cloud on the shared ego grid
            pts = batch["points"]
            pil = pillarize_batch(pts.flatten(0, 1),
                                  batch["points_mask"].flatten(0, 1),
                                  **self.pillar_kw)
            pil = Pillars(*(v.unflatten(0, pts.shape[:2]) for v in pil))
        feats = []
        for t, modalities in self.types:
            sl = self.layout.slots(t)
            bevs = []
            vfe = self.get_submodule(f"{t}_pillar_vfe") if "lidar" in modalities else None
            if vfe is not None and pil is None:
                bevs.append(vfe(batch["points"][:, sl], batch["points_mask"][:, sl]))
            elif vfe is not None:
                bev = pillar_bev(vfe, Pillars(*(v[:, sl].flatten(0, 1) for v in pil)),
                                 self.grid)
                bevs.append(bev.unflatten(0, (-1, sl.stop - sl.start)))
            if "cam" in modalities:
                if f"cam_{t}" not in batch:
                    raise KeyError(f"the config gives {t} the cam modality but "
                                   f"the batch has no 'cam_{t}' inputs")
                cam = {k: v[:, sl].flatten(0, 1)
                       for k, v in batch[f"cam_{t}"].items()}
                bev = self.get_submodule(f"{t}_lss")(cam, mark)
                bevs.append(bev.reshape((-1, sl.stop - sl.start) + bev.shape[1:]))
            # mean over modalities (the reference's fuse_bev)
            feats.append(bevs[0] if len(bevs) == 1
                         else torch.stack(bevs).mean(0))
        x = torch.cat(feats, dim=1)  # (B, L, ny, nx, C)
        # zero the padding agents' features
        return x * batch["agent_mask"][:, :, None, None, None].to(x.dtype)
