"""Pillar -> dense BEV scatter (counterpart of airv2x_tpu/ops/scatter.py):
featurized pillars (..., P, C) with zyx ``coords`` land on a channel-last
(..., ny, nx, C) canvas (rows follow y, columns x); empty pillar slots
(mask False) go to a spare row and column that are cut off."""

from __future__ import annotations

import torch


def scatter_pillars_to_bev_batch(pillar_features, coords, mask, *, ny: int,
                                 nx: int):
    """(B, P, C) pillar features, (B, P, 3) int zyx coords and (B, P) mask
    -> (B, ny, nx, C); z is ignored (nz == 1 for pillars)."""
    b, _, c = pillar_features.shape
    y = torch.where(mask, coords[..., 1], ny).long()
    x = torch.where(mask, coords[..., 2], nx).long()
    bi = torch.arange(b, device=y.device)[:, None].expand_as(y)
    canvas = pillar_features.new_zeros((b, ny + 1, nx + 1, c))
    canvas[bi, y, x] = pillar_features
    return canvas[:, :ny, :nx]


def scatter_pillars_to_bev(pillar_features, coords, mask, *, ny: int, nx: int):
    """One cloud: (P, C) -> (ny, nx, C)."""
    return scatter_pillars_to_bev_batch(pillar_features[None], coords[None],
                                        mask[None], ny=ny, nx=nx)[0]


def scatter_voxels_to_grid_batch(voxel_features, coords, mask, *, nz: int,
                                 ny: int, nx: int):
    """(B, V, C) voxel features into a dense (B, nz, ny, nx, C) grid: the
    3D analog of the pillar scatter."""
    b, _, c = voxel_features.shape
    z = torch.where(mask, coords[..., 0], nz).long()
    y = torch.where(mask, coords[..., 1], ny).long()
    x = torch.where(mask, coords[..., 2], nx).long()
    bi = torch.arange(b, device=y.device)[:, None].expand_as(y)
    canvas = voxel_features.new_zeros((b, nz + 1, ny + 1, nx + 1, c))
    canvas[bi, z, y, x] = voxel_features
    return canvas[:, :nz, :ny, :nx]


def scatter_voxels_to_grid(voxel_features, coords, mask, *, nz: int, ny: int,
                           nx: int):
    """One cloud: (V, C) -> (nz, ny, nx, C)."""
    return scatter_voxels_to_grid_batch(voxel_features[None], coords[None],
                                        mask[None], nz=nz, ny=ny, nx=nx)[0]
