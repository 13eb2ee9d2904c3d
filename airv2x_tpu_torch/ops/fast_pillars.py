"""Sort-free PointPillars encoder, eval path (counterpart of
airv2x_tpu/ops/fast_pillars.py: ``point_cell_ids`` and ``FastPillarBEV``).

The single PFN layer (Linear -> eval BN -> ReLU) is pointwise over points,
and eval BN is a per-channel affine ``a*x + b``, so the per-pillar max
commutes with the whole layer once channels with ``a < 0`` are flipped. The
pillar mean enters every point of a cell through the same term
``W_cl @ mean_cell`` (W_cl = the f_cluster columns of the dense weight):

    feat_cell = relu(bn(smax_cell - W_cl @ mean_cell)), floored at
    relu(bn(dense(0))) (the zero padding rows of the classic path).

So the encoder is one (N, d_in) x (d_in, C) matmul over all points plus one
call of K1 (``ops/pillar_encode.py``), which scatter-maxes the flipped
features and scatter-adds the cell-centre residuals and applies that
epilogue. The training path waits for a later slice.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from airv2x_tpu_torch.models.nn import MaskedBatchNorm
from airv2x_tpu_torch.ops.pillar_encode import pillar_encode


def point_cell_ids(points, mask, lidar_range, voxel_size, nx: int, ny: int):
    """Per-point flat BEV cell id.

    points (..., N, F>=3); mask (..., N) -> (ids (..., N) int32 in
    [0, ny*nx), valid (..., N)). Out-of-range points are invalidated.
    """
    x0, y0, z0, x1, y1, z1 = [float(v) for v in lidar_range[:6]]
    vx, vy = float(voxel_size[0]), float(voxel_size[1])
    ix = torch.floor((points[..., 0] - x0) / vx).to(torch.int32)
    iy = torch.floor((points[..., 1] - y0) / vy).to(torch.int32)
    valid = (
        mask
        & (ix >= 0)
        & (ix < nx)
        & (iy >= 0)
        & (iy < ny)
        & (points[..., 2] >= z0)
        & (points[..., 2] <= z1)
    )
    ids = iy.clamp(0, ny - 1) * nx + ix.clamp(0, nx - 1)
    return torch.where(valid, ids, torch.zeros_like(ids)), valid


class FastPillarBEV(nn.Module):
    """Points straight to a (ny, nx, C) BEV map in eval mode.

    Parameters mirror a single PFN layer: ``dense`` (flax ``Dense_0``) and
    ``bn`` (flax ``MaskedBatchNorm_0``). ``offset_voxel_size`` /
    ``offset_lidar_range`` are the agent type's own constants for the
    cell-centre offset features; the grid and the residuals fed to K1 use
    the shared ego grid constants (``voxel_size`` / ``lidar_range``).
    """

    FLAX_NAMES = {"dense": "Dense_0", "bn": "MaskedBatchNorm_0"}

    def __init__(
        self,
        num_filters: Sequence[int],
        voxel_size: Sequence[float],
        lidar_range: Sequence[float],
        use_norm: bool = True,
        with_distance: bool = False,
        use_absolute_xyz: bool = True,
        offset_voxel_size: Sequence[float] | None = None,
        offset_lidar_range: Sequence[float] | None = None,
        num_point_features: int = 4,
    ):
        super().__init__()
        if len(num_filters) != 1:
            raise ValueError(
                "FastPillarBEV supports single-PFN-layer configs only; got "
                f"num_filters={list(num_filters)}"
            )
        if (use_norm, with_distance, use_absolute_xyz) != (True, False, True):
            raise NotImplementedError(
                "only the AirV2X PFN (use_norm, no distance, absolute xyz) "
                "is ported"
            )
        self.out_c = int(num_filters[0])
        self.voxel_size = [float(v) for v in voxel_size]
        self.lidar_range = [float(v) for v in lidar_range]
        self.offset_voxel_size = [float(v) for v in offset_voxel_size or voxel_size]
        self.offset_lidar_range = [
            float(v) for v in offset_lidar_range or lidar_range
        ]
        lr, vs = self.lidar_range, self.voxel_size
        self.nx = int(round((lr[3] - lr[0]) / vs[0]))
        self.ny = int(round((lr[4] - lr[1]) / vs[1]))
        # input [x, y, z, i, x, y, z, f_center]; BN follows, so no bias
        self.dense = nn.Linear(num_point_features + 6, self.out_c, bias=False)
        self.bn = MaskedBatchNorm(self.out_c)

    def kernel_inputs(self, points, mask):
        """The per-point side of the eval path: K1's arguments for
        ``points`` (..., N, F) and ``mask`` (..., N), maps = leading dims."""
        lr, vs = self.lidar_range, self.voxel_size
        ovs, olr = self.offset_voxel_size, self.offset_lidar_range
        nx, ny, out_c = self.nx, self.ny, self.out_c
        cells = nx * ny
        n = points.shape[-2]
        m = math.prod(points.shape[:-2])
        dtype = self.dense.weight.dtype
        pts_flat = points.reshape(m * n, points.shape[-1])
        ids, valid = point_cell_ids(pts_flat, mask.reshape(m * n), lr, vs, nx, ny)
        pts = pts_flat.to(dtype)
        w = valid.to(torch.float32)[:, None]
        ix = (ids % nx).to(dtype)
        iy = torch.div(ids, nx, rounding_mode="floor").to(dtype)

        # cell-centre offsets with the agent type's own constants
        cx = (ix + 0.5) * ovs[0] + olr[0]
        cy = (iy + 0.5) * ovs[1] + olr[1]
        cz = ovs[2] / 2 + olr[2]
        f_center = torch.stack(
            [pts[:, 0] - cx, pts[:, 1] - cy, pts[:, 2] - cz], dim=-1
        )
        x_tilde = torch.cat([pts, pts[:, :3], f_center], dim=-1)
        x_tilde = torch.where(valid[:, None], x_tilde, torch.zeros_like(x_tilde))
        u = self.dense(x_tilde)  # (N, C)

        a_k, b_k = self.bn.affine()
        flip = torch.where(a_k >= 0, 1.0, -1.0).to(dtype)

        # per-cell mean residuals use the shared grid constants, so every
        # residual is bounded by the grid voxel
        gx = (ix + 0.5) * vs[0] + lr[0]
        gy = (iy + 0.5) * vs[1] + lr[1]
        gz = vs[2] / 2 + lr[2]
        resid = torch.stack([pts[:, 0] - gx, pts[:, 1] - gy, pts[:, 2] - gz],
                            dim=-1)

        # padding floor relu(bn(dense(0))); W_cl, the f_cluster columns (the
        # dense has no bias, so this is dense(basis) - dense(0) exactly)
        zrow = torch.zeros((1, x_tilde.shape[-1]), dtype=dtype, device=pts.device)
        pad_floor = torch.relu(self.bn(self.dense(zrow)))[0]
        f = pts.shape[-1]
        wcl = self.dense.weight[:, f:f + 3].T  # (3, C)
        params = torch.cat(
            [wcl, torch.stack([a_k, b_k, flip, pad_floor])], dim=0
        ).to(torch.float32).contiguous()

        ids_k = torch.where(valid, ids, torch.full_like(ids, cells))
        return (
            ids_k.reshape(m, n).contiguous(),
            (u * flip).to(torch.float32).reshape(m, n, out_c).contiguous(),
            torch.cat([w, resid.to(torch.float32) * w], dim=-1)
            .reshape(m, n, 4).contiguous(),
            params,
            dict(
                cells=cells,
                nx=nx,
                grid_consts=(vs[0], vs[1], lr[0] + 0.5 * vs[0],
                             lr[1] + 0.5 * vs[1], vs[2] / 2 + lr[2]),
                out_dtype=dtype,
            ),
        )

    def forward(self, points, mask):
        """points (..., N, F>=4), mask (..., N) -> (..., ny, nx, C)."""
        if self.training:
            raise NotImplementedError(
                "FastPillarBEV's training path is not ported yet; call .eval()"
            )
        ids, feat, aux, params, kw = self.kernel_inputs(points, mask)
        grid = pillar_encode(ids, feat, aux, params, **kw)
        return grid.reshape(points.shape[:-2] + (self.ny, self.nx, self.out_c))
