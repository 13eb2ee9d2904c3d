"""K3, the fused pillar reduce: kernel wrapper and its plain PyTorch version
(counterpart of airv2x_tpu/ops/pallas_pillars.py: ``fused_pillar_reduce``
and ``reference_pillar_reduce``).

Per map, a scatter-max of lanes 0:64 and a scatter-add of lanes 64:128 of
packed point rows into ``cells + 8`` rows; row ``cells`` is the dump row for
invalid points. The CUDA kernel is ``csrc/pillar_reduce.cu``; its note says
what bounds it and how it is laid out.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch import kernels

LANES = 128
FEAT = 64  # lanes [0:64] take the max; lane 64 the count, 65:68 residuals
NEG = -1e9
# The JAX kernel keeps one map's (cells + 8, 128) f32 accumulator in the
# TPU's VMEM and refuses larger grids; the port keeps the same limit so
# both packages accept the same inputs.
MAX_CELLS = 165_000


def _check(ids, vals, cells: int):
    if cells > MAX_CELLS:
        raise ValueError(
            f"grid of {cells} cells exceeds the kernel limit ({MAX_CELLS})")
    if ids.dim() != 2 or ids.dtype != torch.int32:
        raise ValueError(f"pillar_reduce: ids must be int32 (m, n), got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if tuple(vals.shape) != tuple(ids.shape) + (LANES,):
        raise ValueError(f"pillar_reduce: vals must be (m, n, {LANES}), got "
                         f"{tuple(vals.shape)}")
    if vals.device != ids.device:
        raise ValueError(f"pillar_reduce: vals is on {vals.device}, ids on "
                         f"{ids.device}")


def pillar_reduce(ids, vals, cells: int):
    """Per-map fused scatter-max + scatter-add.

    ids:  (m, n) int32 cell ids in [0, cells]; invalid points must already
          point at ``cells``, the dump row.
    vals: (m, n, 128); lanes 0:64 feature values (-1e9 for invalid points),
          lane 64 the count weight, lanes 65:68 weighted residuals. Widened
          to f32.
    Returns (m, cells + 8, 128) f32: lanes 0:64 the max (from -1e9), lanes
    64:128 the sums (from 0); rows [cells:] are the dump rows.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    _check(ids, vals, cells)
    vals = vals.to(torch.float32)
    if ids.device.type == "cpu":
        return pillar_reduce_plain(ids, vals, cells)
    if ids.device.type != "cuda":
        raise ValueError(f"pillar_reduce: unsupported device {ids.device}")
    m, n = ids.shape
    rows = cells + 8
    ids, vals = ids.contiguous(), vals.contiguous()
    out = torch.empty((m, rows, LANES), dtype=torch.float32, device=ids.device)
    with torch.cuda.device(ids.device):
        err = kernels.lib("pillar_reduce").pillar_reduce(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), m, n, rows,
            kernels.current_stream(),
        )
    kernels.check("pillar_reduce", err)
    kernels.LAUNCHES["pillar_reduce"] += 1
    return out


def pillar_reduce_plain(ids, vals, cells: int):
    """Plain PyTorch version of ``pillar_reduce``: ``scatter_reduce_``
    ("amax", from -1e9) on lanes 0:64 and ``index_add_`` on lanes 64:128
    over the flattened (map, row) index."""
    _check(ids, vals, cells)
    m, n = ids.shape
    rows = cells + 8
    dev = ids.device
    vals = vals.to(torch.float32).reshape(m * n, LANES)
    flat = (ids.long() + torch.arange(m, device=dev)[:, None] * rows).reshape(-1)
    mx = torch.full((m * rows, FEAT), NEG, dtype=torch.float32, device=dev)
    mx.scatter_reduce_(0, flat[:, None].expand(-1, FEAT), vals[:, :FEAT],
                       "amax", include_self=True)
    sums = torch.zeros((m * rows, LANES - FEAT), dtype=torch.float32,
                       device=dev)
    sums.index_add_(0, flat, vals[:, FEAT:])
    return torch.cat([mx, sums], dim=-1).reshape(m, rows, LANES)
