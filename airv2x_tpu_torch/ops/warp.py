"""Bilinear grid sampling (counterpart of airv2x_tpu/ops/warp.py:
``grid_sample_bilinear``; the affine warps wait for the models that use
them). Layout: channel-last (..., H, W, C), as in the JAX package."""

from __future__ import annotations

import torch


def grid_sample_bilinear(src, grid_x, grid_y):
    """Bilinear sample of ``src`` (..., H, W, C) at pixel coordinates
    ``grid_x`` / ``grid_y`` (out_h, out_w) -> (..., out_h, out_w, C).

    Four clamped gathers; a tap outside the source contributes zero (torch
    ``padding_mode='zeros'``). The weights keep the grid's dtype, so a bf16
    ``src`` sampled on an f32 grid gives f32, as in the JAX package.
    """
    h, w = src.shape[-3], src.shape[-2]
    x0 = torch.floor(grid_x)
    y0 = torch.floor(grid_y)
    tx = (grid_x - x0)[..., None]
    ty = (grid_y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = src[..., yi.clamp(0, h - 1), xi.clamp(0, w - 1), :]
        return v * inside[..., None].to(src.dtype)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty
