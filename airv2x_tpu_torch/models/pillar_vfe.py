"""PointPillars voxel feature encoder on fixed-capacity pillars
(counterpart of airv2x_tpu/models/pillar_vfe.py: ``PFNLayer``,
``augment_pillar_points``, ``PillarVFE``).

The classic path of the encoders: ``ops/voxelize.py`` groups the points
into (P, K, 4) pillars, each point gets the 10-dim augmentation (raw xyzi,
the offset from its pillar's mean, the offset from its cell centre), and
each PFN layer is Linear -> masked BN -> ReLU -> max over the K points.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from airv2x_tpu_torch.models.nn import MaskedBatchNorm
from airv2x_tpu_torch.ops.scatter import scatter_pillars_to_bev_batch


class PFNLayer(nn.Module):
    """Linear -> BN -> ReLU -> max over the K point rows of each pillar.

    As in the reference, padded point rows are zeroed at the input but still
    flow through the layer, so a pillar that is not full takes relu(bn(0))
    into its max; the BN statistics in train mode cover every row of the
    occupied pillars (``pillar_mask``), not the empty pillar slots."""

    FLAX_NAMES = {"linear": "Dense_0", "norm": "MaskedBatchNorm_0"}

    def __init__(self, in_c: int, out_channels: int, use_norm: bool = True,
                 last_layer: bool = True):
        super().__init__()
        self.last_layer = last_layer
        out_c = out_channels if last_layer else out_channels // 2
        self.linear = nn.Linear(in_c, out_c, bias=not use_norm)
        self.norm = MaskedBatchNorm(out_c) if use_norm else None

    def forward(self, feats, pillar_mask):
        """feats (..., P, K, Cin) with the padded rows zeroed; pillar_mask
        (..., P)."""
        x = self.linear(feats)
        if self.norm is not None:
            x = self.norm(x, pillar_mask[..., None].expand(x.shape[:-1]))
        x = torch.relu(x)
        x_max = x.amax(dim=-2, keepdim=True)
        if self.last_layer:
            return x_max[..., 0, :]
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


def augment_pillar_points(voxels, num_points, coords, *, voxel_size,
                          lidar_range, use_absolute_xyz: bool = True,
                          with_distance: bool = False, dtype=torch.float32):
    """The per-point augmentation of the pillar encoders: raw xyzi, the
    offset from the pillar's mean, the offset from the cell centre (and the
    distance). Returns (feats (..., P, K, F'), point_mask (..., P, K)), the
    padded rows zero."""
    k = voxels.shape[-2]
    pts = voxels.to(dtype)
    cnt = num_points.clamp_min(1).to(dtype)[..., None, None]
    point_mask = (torch.arange(k, device=voxels.device)
                  < num_points[..., None])
    xyz = pts[..., :3]
    mean = torch.where(point_mask[..., None], xyz, 0.0).sum(-2, keepdim=True) / cnt
    f_cluster = xyz - mean
    vx, vy, vz = (float(v) for v in voxel_size[:3])
    x0, y0, z0 = (float(v) for v in lidar_range[:3])
    cx = coords[..., 2, None].to(dtype) * vx + (vx / 2 + x0)
    cy = coords[..., 1, None].to(dtype) * vy + (vy / 2 + y0)
    cz = coords[..., 0, None].to(dtype) * vz + (vz / 2 + z0)
    f_center = torch.stack([pts[..., 0] - cx, pts[..., 1] - cy,
                            pts[..., 2] - cz], dim=-1)
    feats = [pts if use_absolute_xyz else pts[..., 3:], f_cluster, f_center]
    if with_distance:
        feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
    x = torch.cat(feats, dim=-1)
    return torch.where(point_mask[..., None], x, 0.0), point_mask


class PillarVFE(nn.Module):
    """(..., P, K, 4) pillars -> (..., P, C) pillar features, zero for the
    empty slots. It computes in its Linear's dtype (bf16 after the serving
    cast), the BN in f32 as the JAX package."""

    FLAX_NAMES = {"pfn": "PFNLayer"}

    def __init__(self, num_filters: Sequence[int], voxel_size, lidar_range,
                 use_norm: bool = True, with_distance: bool = False,
                 use_absolute_xyz: bool = True):
        super().__init__()
        self.voxel_size, self.lidar_range = voxel_size, lidar_range
        self.use_absolute_xyz, self.with_distance = use_absolute_xyz, with_distance
        in_c = (4 if use_absolute_xyz else 1) + 6 + int(with_distance)
        filters = [int(f) for f in num_filters]
        self.pfn = nn.ModuleList()
        for i, out_c in enumerate(filters):
            self.pfn.append(PFNLayer(in_c, out_c, use_norm,
                                     last_layer=i == len(filters) - 1))
            in_c = out_c
        self.out_c = filters[-1]

    def forward(self, voxels, num_points, coords, pillar_mask):
        x, _ = augment_pillar_points(
            voxels, num_points, coords, voxel_size=self.voxel_size,
            lidar_range=self.lidar_range,
            use_absolute_xyz=self.use_absolute_xyz,
            with_distance=self.with_distance,
            dtype=self.pfn[0].linear.weight.dtype)
        for layer in self.pfn:
            x = layer(x, pillar_mask)
        return x * pillar_mask[..., None].to(x.dtype)


def pillar_bev(vfe: PillarVFE, pil, grid) -> torch.Tensor:
    """The classic path's BEV map: ``vfe`` on the (N, P, K, 4) pillars
    ``pil`` (``ops/voxelize.py:Pillars``), scattered onto the (nx, ny, nz)
    ``grid`` -> (N, ny, nx, C)."""
    pf = vfe(pil.voxels, pil.num_points, pil.coords, pil.mask)
    return scatter_pillars_to_bev_batch(pf, pil.coords, pil.mask, ny=grid[1],
                                        nx=grid[0])
