"""Point-cloud pillarization into fixed-capacity pillars (counterpart of
airv2x_tpu/ops/voxelize.py: ``Pillars``, ``pillarize``,
``pillarize_batch``).

The reference voxelizes on the host with spconv's ``Point2VoxelCPU3d``
(``voxels (M, K, 4)``, zyx ``coords (M, 3)``, ``num_points (M,)`` under
the caps ``max_voxels`` / ``max_points_per_voxel``). Here, as in the JAX
package, it is a shape-static device program:

  1. quantize the points to integer cells (``floor``) and invalidate the
     out-of-range and padding points;
  2. one stable sort by cell id (invalid points sort last);
  3. run-length ids of the sorted cells give each point its pillar slot and
     its rank within the pillar (cumsum / cummax, no loops);
  4. scatters build the (P, K, F) pillar tensor and the per-pillar
     metadata. Overflow is dropped as the JAX package drops it: pillars
     beyond ``max_pillars`` in cell-id order, points beyond
     ``max_points_per_pillar`` in their original order. Every scatter
     writes the dropped entries to a spare row that is cut off, so no step
     waits on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class Pillars(NamedTuple):
    """Fixed-capacity pillarization result.

    voxels:     (..., P, K, F) points grouped by pillar (zero-padded).
    coords:     (..., P, 3) int32 zyx cell coordinates (zeros for empty slots).
    num_points: (..., P) int32 valid point count per pillar.
    mask:       (..., P) bool pillar occupancy.
    """

    voxels: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    mask: torch.Tensor


def grid_size(lidar_range, voxel_size) -> tuple:
    """(nx, ny, nz) = round((max - min) / voxel) per axis."""
    return tuple(int(round((float(lidar_range[3 + i]) - float(lidar_range[i]))
                           / float(voxel_size[i]))) for i in range(3))


def pillar_kwargs(preprocess: dict) -> dict:
    """``pillarize``'s settings from a config's preprocess block: the shared
    grid and spconv's caps (``max_voxel_train``, ``max_points_per_voxel``)."""
    args = preprocess["args"]
    return dict(lidar_range=preprocess["cav_lidar_range"],
                voxel_size=args["voxel_size"],
                grid_size=grid_size(preprocess["cav_lidar_range"],
                                    args["voxel_size"]),
                max_pillars=int(args.get("max_voxel_train", 16000)),
                max_points_per_pillar=int(args.get("max_points_per_voxel", 32)))


def pillarize(points, points_mask, *, lidar_range, voxel_size,
              grid_size: Sequence[int], max_pillars: int,
              max_points_per_pillar: int) -> Pillars:
    """Voxelize one padded point cloud into fixed-capacity pillars.

    points (N, F) f32, F >= 3 (x, y, z, features...); points_mask (N,) bool,
    False for padding; lidar_range [xmin, ymin, zmin, xmax, ymax, zmax];
    voxel_size [vx, vy, vz]; grid_size (nx, ny, nz), which must equal
    round((max - min) / voxel); the caps are spconv's max_voxels /
    max_points_per_voxel.
    """
    n, f = points.shape
    dev = points.device
    nx, ny, nz = (int(g) for g in grid_size)
    p_cap, k_cap = int(max_pillars), int(max_points_per_pillar)

    lo = torch.as_tensor([float(v) for v in lidar_range[:3]], dtype=points.dtype,
                         device=dev)
    vs = torch.as_tensor([float(v) for v in voxel_size[:3]], dtype=points.dtype,
                         device=dev)
    idx = torch.floor((points[:, :3] - lo) / vs).to(torch.int32)
    ix, iy, iz = idx.unbind(-1)
    valid = ((ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0)
             & (iz < nz) & points_mask)

    big = nx * ny * nz  # sentinel: sorts after every real cell
    cell = torch.where(valid, (iz * ny + iy) * nx + ix,
                       torch.full_like(ix, big))
    cell_s, order = torch.sort(cell, stable=True)
    pts_s = points[order]
    valid_s = cell_s < big

    pos = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_run = torch.cat([first, cell_s[1:] != cell_s[:-1]]) & valid_s
    pillar_id = torch.cumsum(new_run.to(torch.int32), 0, dtype=torch.int32) - 1
    run_start = torch.cummax(
        torch.where(new_run, pos, torch.full_like(pos, -1)), 0).values
    rank = pos - run_start  # the rank within the pillar, in point order

    keep = valid_s & (rank < k_cap) & (pillar_id >= 0) & (pillar_id < p_cap)
    pid = torch.where(keep, pillar_id, p_cap).long()
    rnk = torch.where(keep, rank, k_cap).long()
    voxels = torch.zeros((p_cap + 1, k_cap + 1, f), dtype=points.dtype, device=dev)
    voxels[pid, rnk] = pts_s
    num_points = torch.zeros(p_cap + 1, dtype=torch.int32, device=dev)
    num_points.index_add_(0, pid, keep.to(torch.int32))

    start_keep = new_run & (pillar_id < p_cap)
    spid = torch.where(start_keep, pillar_id, p_cap).long()
    cell_of_pillar = torch.zeros(p_cap + 1, dtype=torch.int32, device=dev)
    cell_of_pillar[spid] = cell_s
    mask = torch.zeros(p_cap + 1, dtype=torch.bool, device=dev)
    mask[spid] = start_keep
    cell_of_pillar, mask = cell_of_pillar[:p_cap], mask[:p_cap]

    cz = torch.div(cell_of_pillar, ny * nx, rounding_mode="floor")
    rem = cell_of_pillar - cz * (ny * nx)
    cy = torch.div(rem, nx, rounding_mode="floor")
    cx = rem - cy * nx
    coords = torch.where(mask[:, None], torch.stack([cz, cy, cx], -1), 0)
    return Pillars(voxels=voxels[:p_cap, :k_cap], coords=coords.to(torch.int32),
                   num_points=num_points[:p_cap], mask=mask)


def pillarize_batch(points, points_mask, **kw) -> Pillars:
    """:func:`pillarize` over a leading batch / agent axis (B, N, F)."""
    outs = [pillarize(p, m, **kw) for p, m in zip(points, points_mask)]
    return Pillars(*(torch.stack(t) for t in zip(*outs)))
