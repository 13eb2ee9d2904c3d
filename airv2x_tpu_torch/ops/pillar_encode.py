"""K1, the fused pillar encode: kernel wrapper and its plain PyTorch version.

Counterpart of airv2x_tpu/ops/pallas_pillars.py:fused_pillar_encode
(``_encode_kernel``). The CUDA kernel is ``csrc/pillar_encode.cu``; its note
says what bounds it and how it is laid out.

The public interface carries none of the TPU kernel's padding: no dump row,
no 128-lane packing, no cell-count gate. Points whose id is outside
``[0, cells)`` are skipped, and C is taken from the input.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch import kernels

NEG = -1e9  # initial value of the per-cell feature max


def _check_inputs(ids, feat, aux, params):
    m, n = ids.shape
    c = feat.shape[-1]
    want = {
        "ids": (ids, torch.int32, (m, n)),
        "feat": (feat, torch.float32, (m, n, c)),
        "aux": (aux, torch.float32, (m, n, 4)),
        "params": (params, torch.float32, (7, c)),
    }
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"pillar_encode: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != ids.device:
            raise ValueError(f"pillar_encode: {name} is on {t.device}, "
                             f"ids on {ids.device}")
        if not t.is_contiguous():
            raise ValueError(f"pillar_encode: {name} must be contiguous")


def pillar_encode(ids, feat, aux, params, *, cells: int, nx: int,
                  grid_consts: tuple, out_dtype=torch.float32):
    """Points -> final eval-mode BEV grid, per map.

    ids:    (m, n) int32 local cell ids; ids outside [0, cells) are skipped.
    feat:   (m, n, C) f32 flipped PFN features u * flip.
    aux:    (m, n, 4) f32 [valid weight, weighted cell-centre residuals x/y/z].
    params: (7, C) f32 rows 0:3 W_cl (the f_cluster columns of the PFN dense),
            3 BN scale a, 4 BN shift b, 5 flip sign, 6 padding floor.
    grid_consts: (vsx, vsy, cx0, cy0, cz): voxel sizes, the centre of cell
            (0, 0) and the constant z centre.
    Returns (m, cells, C) in ``out_dtype`` (float32 or bfloat16).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    _check_inputs(ids, feat, aux, params)
    if ids.device.type == "cpu":
        return pillar_encode_plain(ids, feat, aux, params, cells=cells, nx=nx,
                                   grid_consts=grid_consts, out_dtype=out_dtype)
    if ids.device.type != "cuda":
        raise ValueError(f"pillar_encode: unsupported device {ids.device}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pillar_encode: out_dtype {out_dtype} unsupported")
    m, n = ids.shape
    c = feat.shape[-1]
    if cells * c >= 2**31 or m > 65535:  # 32-bit cell offsets, grid.y = m
        raise ValueError(f"pillar_encode: {m} maps of {cells} cells x {c} "
                         "channels is past the kernel's limits")
    dev = ids.device
    # workspace: the (m, cells) cell -> leader table, then the (m, n, C + 4)
    # compact rows, which start 16-byte aligned
    table_words = -(-m * cells // 4) * 4
    ws = torch.empty(table_words + m * n * (c + 4), dtype=torch.int32,
                     device=dev)
    out = torch.empty((m, cells, c), dtype=out_dtype, device=dev)
    vsx, vsy, cx0, cy0, cz = (float(v) for v in grid_consts)
    with torch.cuda.device(dev):
        err = kernels.lib("pillar_encode").pillar_encode(
            ids.data_ptr(), feat.data_ptr(), aux.data_ptr(), params.data_ptr(),
            ws.data_ptr(), ws.data_ptr() + 4 * table_words, out.data_ptr(),
            m, n, cells, c, nx, 1.0 / nx, vsx, vsy, cx0, cy0, cz,
            int(out_dtype == torch.bfloat16), kernels.current_stream(),
        )
    kernels.check("pillar_encode", err)
    kernels.LAUNCHES["pillar_encode"] += 1
    return out


def pillar_encode_plain(ids, feat, aux, params, *, cells: int, nx: int,
                        grid_consts: tuple, out_dtype=torch.float32):
    """Plain PyTorch version of ``pillar_encode``: a scatter-max
    (``scatter_reduce_`` "amax") and a scatter-add (``index_add_``) into
    per-map rows with one dump row for skipped points, then the epilogue."""
    m, n = ids.shape
    c = feat.shape[-1]
    dev = ids.device
    rows = cells + 1  # row ``cells`` collects the skipped points
    valid = (ids >= 0) & (ids < cells)
    local = torch.where(valid, ids, torch.full_like(ids, cells)).long()
    flat = (local + torch.arange(m, device=dev)[:, None] * rows).reshape(-1)
    mx = torch.full((m * rows, c), NEG, dtype=torch.float32, device=dev)
    mx.scatter_reduce_(0, flat[:, None].expand(-1, c), feat.reshape(-1, c),
                       "amax", include_self=True)
    sums = torch.zeros((m * rows, 4), dtype=torch.float32, device=dev)
    sums.index_add_(0, flat, aux.reshape(-1, 4))
    mx = mx.view(m, rows, c)[:, :cells]
    sums = sums.view(m, rows, 4)[:, :cells]
    return encode_epilogue(mx, sums, params, nx=nx, grid_consts=grid_consts
                           ).to(out_dtype)


def encode_epilogue(mx, sums, params, *, nx: int, grid_consts: tuple):
    """f32 epilogue of the TPU kernel (pallas_pillars.py:_encode_kernel):
    cell mean -> W_cl . mean -> BN affine -> relu -> padding floor ->
    occupancy mask. mx (m, cells, C), sums (m, cells, 4)."""
    vsx, vsy, cx0, cy0, cz = (float(v) for v in grid_consts)
    cells = mx.shape[1]
    wcl0, wcl1, wcl2, a, b, flip, floor = params
    cnt = sums[..., 0:1]
    denom = torch.clamp_min(cnt, 1.0)
    # row -> (iy, ix) via the reciprocal multiply shifted by +0.5, as on the
    # TPU: the product then sits >= 0.5/nx from every integer, so f32
    # rounding never crosses a floor boundary
    rf = torch.arange(cells, dtype=torch.float32, device=mx.device)[:, None]
    inv_nx = torch.tensor(1.0 / nx, dtype=torch.float32, device=mx.device)
    iy = torch.floor((rf + 0.5) * inv_nx)
    ix = rf - iy * nx
    mean_x = sums[..., 1:2] / denom + (ix * vsx + cx0)
    mean_y = sums[..., 2:3] / denom + (iy * vsy + cy0)
    mean_z = sums[..., 3:4] / denom + cz
    m_cell = mean_x * wcl0 + mean_y * wcl1 + mean_z * wcl2
    v = (mx * flip - m_cell) * a + b
    occ = torch.clamp_max(cnt, 1.0)
    return occ * torch.maximum(torch.relu(v), floor)
