"""Bilinear grid sampling and the STTF affine warp into the ego frame
(counterpart of airv2x_tpu/ops/warp.py: ``grid_sample_bilinear``,
``warp_affine``, ``discretized_transform``, ``center_pixel_affine``,
``warp_bev_features``, ``rotated_roi_mask`` and the normalized-coordinate
pair ``warp_affine_normalized`` / ``normalized_pairwise_affine`` that SCOPE,
V2VNet, When2com, HEAL's pyramid and SiCP use). Layout: channel-last (..., H, W, C), as in the JAX package.

The affine arithmetic is written out as f32 products and sums (no matmul,
so no TF32 on the card, and no division by a host scalar, which CUDA turns
into a product with its reciprocal): the card and the CPU compute the same
sample coordinates bit for bit.
"""

from __future__ import annotations

import torch


def grid_sample_bilinear(src, grid_x, grid_y, src_index=None):
    """Bilinear sample of ``src`` (..., H, W, C) at pixel coordinates
    ``grid_x`` / ``grid_y`` (out_h, out_w) -> (..., out_h, out_w, C); or,
    with one grid per map, of ``src`` (N, H, W, C) at ``grid_x`` / ``grid_y``
    (K, out_h, out_w) -> (K, out_h, out_w, C), grid k sampling map
    ``src_index[k]`` (by default map k).

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
    per_map = grid_x.dim() == 3
    if per_map:
        n = (torch.arange(src.shape[0], device=src.device)
             if src_index is None else src_index)[:, None, None]

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        yc, xc = yi.clamp(0, h - 1), xi.clamp(0, w - 1)
        v = src[n, yc, xc] if per_map else src[..., yc, xc, :]
        return v * inside[..., None].to(src.dtype)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - tx) + v01 * tx
    bot = v10 * (1 - tx) + v11 * tx
    return top * (1 - ty) + bot * ty


def warp_affine(src, M, dsize):
    """Warp (..., H, W, C) features by the pixel affine ``M`` (..., 2, 3):
    the output at dst pixel p samples src at ``A^-1 p``, the 2x3 inverse
    taken analytically (a determinant within 1e-12 of zero divides by 1), as
    the JAX package's ``warp_affine`` with ``align_corners=True``."""
    out_h, out_w = dsize
    lead = src.shape[:-3]
    ms = M.reshape(-1, 2, 3).to(torch.float32)
    srcs = src.reshape((-1,) + src.shape[-3:])
    r00, r01, t0 = ms[:, 0, 0], ms[:, 0, 1], ms[:, 0, 2]
    r10, r11, t1 = ms[:, 1, 0], ms[:, 1, 1], ms[:, 1, 2]
    det = r00 * r11 - r01 * r10
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    i00, i01 = r11 * inv_det, -r01 * inv_det
    i10, i11 = -r10 * inv_det, r00 * inv_det
    u0 = -(i00 * t0 + i01 * t1)
    u1 = -(i10 * t0 + i11 * t1)
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=src.device),
        torch.arange(out_w, dtype=torch.float32, device=src.device),
        indexing="ij")

    def per(a):
        return a[:, None, None]

    sx = per(i00) * xs + per(i01) * ys + per(u0)
    sy = per(i10) * xs + per(i11) * ys + per(u1)
    out = grid_sample_bilinear(srcs, sx, sy)
    return out.reshape(lead + (out_h, out_w, src.shape[-1]))


def discretized_transform(pairwise_t, discrete_ratio: float,
                          downsample_rate: float):
    """(..., 4, 4) SE(3) -> (..., 2, 3) pixel-level planar affine: the planar
    rotation block, and the xy translation in metres over the feature
    pixel's size."""
    rot = pairwise_t[..., :2, :2]
    # a device tensor made by a fill: a host scalar would be copied to the
    # card with a stream sync
    pixel = torch.full((), discrete_ratio * downsample_rate,
                       dtype=pairwise_t.dtype, device=pairwise_t.device)
    t = pairwise_t[..., :2, 3:4] / pixel
    return torch.cat([rot, t], dim=-1)


def center_pixel_affine(M, dsize):
    """The (..., 2, 3) affine with its rotation moved about the image
    centre c = (w / 2, h / 2): translation t + c - R c."""
    h, w = dsize
    cx, cy = w / 2.0, h / 2.0
    r00, r01 = M[..., 0, 0], M[..., 0, 1]
    r10, r11 = M[..., 1, 0], M[..., 1, 1]
    t0 = M[..., 0, 2] + (cx - (r00 * cx + r01 * cy))
    t1 = M[..., 1, 2] + (cy - (r10 * cx + r11 * cy))
    return torch.cat([M[..., :2, :2], torch.stack([t0, t1], -1)[..., None]],
                     dim=-1)


def _pixel_affines(pairwise_t, hw, discrete_ratio, downsample_rate):
    m = discretized_transform(pairwise_t, discrete_ratio, downsample_rate)
    return center_pixel_affine(m, hw)


def warp_bev_features(feats, pairwise_t, discrete_ratio, downsample_rate):
    """Warp (B, L, H, W, C) agent features into the ego frame by their
    ``pairwise_t`` (B, L, 4, 4); slot 0, the ego, is left as it is (STTF)."""
    hw = feats.shape[-3], feats.shape[-2]
    m = _pixel_affines(pairwise_t, hw, discrete_ratio, downsample_rate)
    warped = warp_affine(feats[:, 1:], m[:, 1:], hw)
    return torch.cat([feats[:, :1], warped], dim=1)


def rotated_roi_weights(shape_hw, pairwise_t, discrete_ratio, downsample_rate):
    """(B, L, H, W) f32: a canvas of ones warped as each agent's features
    are; ``rotated_roi_mask`` thresholds it at 0.5."""
    h, w = shape_hw
    b, l = pairwise_t.shape[:2]
    ones = torch.ones((b, l, h, w, 1), dtype=torch.float32,
                      device=pairwise_t.device)
    m = _pixel_affines(pairwise_t, (h, w), discrete_ratio, downsample_rate)
    return warp_affine(ones, m, (h, w))[..., 0]


def rotated_roi_mask(shape_hw, pairwise_t, discrete_ratio, downsample_rate):
    """(B, L, H, W) bool: the dst pixels that map inside the source canvas
    after the warp."""
    return rotated_roi_weights(shape_hw, pairwise_t, discrete_ratio,
                               downsample_rate) > 0.5


def device_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """An f32 scalar on ``like``'s device, made by a fill: a division by it
    is a true division on the card too."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def warp_affine_normalized(src, M, src_index=None, align_corners=False):
    """Warp (..., H, W, C) by the (..., 2, 3) affine ``M`` given in
    normalized coordinates: it maps each dst pixel's normalized coordinates
    in [-1, 1] straight to the src's, then samples bilinearly with zero
    padding. With ``align_corners=False`` (``F.affine_grid``'s default,
    SCOPE's and every shipped config's) -1 and 1 lie on the outer pixel
    edges; with True on the outer pixel centres.

    With ``src_index`` (K,), ``src`` is (N, H, W, C), ``M`` (K, 2, 3) and
    affine k warps map ``src_index[k]``: (K, H, W, C), each map sampled as
    it would be warped alone, without K copies of the sources."""
    h, w = src.shape[-3], src.shape[-2]
    lead = src.shape[:-3] if src_index is None else M.shape[:-2]
    ms = M.reshape(-1, 2, 3).to(torch.float32)
    srcs = src.reshape((-1,) + src.shape[-3:])
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=src.device),
        torch.arange(w, dtype=torch.float32, device=src.device),
        indexing="ij")
    if align_corners:
        gx = 2.0 * xs / device_scalar(max(w - 1, 1), ms) - 1.0
        gy = 2.0 * ys / device_scalar(max(h - 1, 1), ms) - 1.0
    else:
        gx = (2.0 * xs + 1.0) / device_scalar(w, ms) - 1.0
        gy = (2.0 * ys + 1.0) / device_scalar(h, ms) - 1.0

    def per(a):
        return a[:, None, None]

    sxn = per(ms[:, 0, 0]) * gx + per(ms[:, 0, 1]) * gy + per(ms[:, 0, 2])
    syn = per(ms[:, 1, 0]) * gx + per(ms[:, 1, 1]) * gy + per(ms[:, 1, 2])
    if align_corners:
        sx = (sxn + 1.0) * 0.5 * (w - 1)
        sy = (syn + 1.0) * 0.5 * (h - 1)
    else:
        sx = ((sxn + 1.0) * w - 1.0) * 0.5
        sy = ((syn + 1.0) * h - 1.0) * 0.5
    out = grid_sample_bilinear(srcs, sx, sy, src_index)
    return out.reshape(lead + (h, w, src.shape[-1]))


def normalized_pairwise_affine(pairwise_t, h: int, w: int,
                               discrete_ratio: float, downsample_rate: float):
    """(..., 4, 4) SE(3) -> (..., 2, 3) affine in normalized coordinates:
    the planar rotation block with its off-diagonals scaled by the aspect
    (h / w and w / h), and the xy translation in metres over half the
    feature map's extent (``downsample_rate * discrete_ratio`` metres per
    pixel)."""
    m = pairwise_t[..., :2, :].to(torch.float32)
    hf, wf = device_scalar(h, m), device_scalar(w, m)
    a00 = m[..., 0, 0]
    a01 = m[..., 0, 1] * h / wf
    a10 = m[..., 1, 0] * w / hf
    a11 = m[..., 1, 1]
    pixel = downsample_rate * discrete_ratio
    t0 = m[..., 0, 3] / device_scalar(pixel * w, m) * 2.0
    t1 = m[..., 1, 3] / device_scalar(pixel * h, m) * 2.0
    return torch.stack([torch.stack([a00, a01, t0], -1),
                        torch.stack([a10, a11, t1], -1)], -2)
