"""The differentiable elementwise rotated-quad IoU (counterpart of
airv2x_tpu/ops/rotated_iou.py: ``polygon_area``, ``quad_intersection_area``
and ``elementwise_quad_iou``), plain PyTorch.

CoAlign's IoU loss reads it; NMS and the AP read K2 (``ops/quad_iou.py``),
whose plain version counts intersections by another construction and
gives 0 to a near-zero-area quad. This one follows the JAX package's XLA
function, its own ``num_valid >= 3`` rule included: the intersection of two
convex quads is the convex hull of at most 24 candidates (the 16 edge-edge
intersections and each quad's corners inside the other, with a metric
boundary tolerance), sorted by angle around their centroid with the same
static bitonic network (so ties sort as they do there), padded with the
first vertex and summed by the shoelace formula. Gradients flow through
the candidates' coordinates, as ``jax.grad`` takes them.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_TOL_M = 1e-4  # boundary tolerance of the corner-inside test, in metres
_NUM_CAND = 24  # 16 edge-edge + 4 + 4 corner-inside candidates
_SORT_N = 32  # candidates padded to a power of two for the bitonic network
_BIG = 1e9


def polygon_area(corners: torch.Tensor) -> torch.Tensor:
    """Shoelace |area| of (..., K, 2) polygons with wraparound."""
    x, y = corners[..., 0], corners[..., 1]
    xn, yn = torch.roll(x, -1, dims=-1), torch.roll(y, -1, dims=-1)
    return 0.5 * torch.abs(torch.sum(x * yn - xn * y, dim=-1))


def _points_in_quad(points, quad):
    """(..., P, 2) points inside the (..., 4, 2) convex quad, either
    winding, within a signed distance of _TOL_M of its edges."""
    edge = torch.roll(quad, -1, dims=-2) - quad
    rel = points[..., :, None, :] - quad[..., None, :, :]  # (..., P, 4, 2)
    cross = (edge[..., None, :, 0] * rel[..., 1]
             - edge[..., None, :, 1] * rel[..., 0])
    lim = _TOL_M * torch.linalg.norm(edge, dim=-1)[..., None, :]
    return (cross >= -lim).all(-1) | (cross <= lim).all(-1)


def _edge_intersections(q1, q2):
    """The 16 intersection points of the quads' edge pairs: (points
    (..., 16, 2), valid (..., 16))."""
    a = q1[..., :, None, :]
    b = torch.roll(q1, -1, dims=-2)[..., :, None, :]
    c = q2[..., None, :, :]
    d = torch.roll(q2, -1, dims=-2)[..., None, :, :]
    r, s = b - a, d - c
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]  # (..., 4, 4)
    qp = c - a
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    ok = denom.abs() > _EPS
    safe = torch.where(ok, denom, torch.ones_like(denom))
    t, u = t_num / safe, u_num / safe
    valid = (ok & (t >= -_EPS) & (t <= 1.0 + _EPS)
             & (u >= -_EPS) & (u <= 1.0 + _EPS))
    pts = a + t[..., None] * r  # (..., 4, 4, 2)
    return pts.flatten(-3, -2), valid.flatten(-2)


def _bitonic_sort_by_key(keys, pts):
    """Ascending sort of (..., N) keys carrying (..., N, 2) points by the
    static bitonic network: each stage compares every lane with the lane
    ``idx ^ j`` and keeps the min or the max by a fixed pattern."""
    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    lead = keys.shape[:-1]

    def partner(a, j):
        shp = a.shape
        g = a.reshape(lead + (n // (2 * j), 2, j) + shp[len(lead) + 1:])
        return torch.flip(g, dims=(len(lead) + 1,)).reshape(shp)

    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            kp, pp = partner(keys, j), partner(pts, j)
            take_min = ((idx & j) == 0) == ((idx & k) == 0)
            take_self = torch.where(take_min, keys <= kp, keys >= kp)
            keys = torch.where(take_min, torch.minimum(keys, kp),
                               torch.maximum(keys, kp))
            pts = torch.where(take_self[..., None], pts, pp)
            j //= 2
        k *= 2
    return keys, pts


def quad_intersection_area(q1, q2):
    """Intersection area of convex quads, (..., 4, 2) x (..., 4, 2) ->
    (...,); 0 where fewer than three candidates are valid."""
    lead = torch.broadcast_shapes(q1.shape[:-2], q2.shape[:-2])
    q1 = q1.expand(lead + q1.shape[-2:])
    q2 = q2.expand(lead + q2.shape[-2:])
    inter_pts, inter_valid = _edge_intersections(q1, q2)
    cand = torch.cat([inter_pts, q1, q2], dim=-2)  # (..., 24, 2)
    valid = torch.cat([inter_valid, _points_in_quad(q1, q2),
                       _points_in_quad(q2, q1)], dim=-1)
    num_valid = valid.sum(-1)
    vmask = valid[..., None]
    centroid = (torch.where(vmask, cand, torch.zeros_like(cand)).sum(-2)
                / num_valid.clamp_min(1)[..., None].to(cand.dtype))
    rel = torch.where(vmask, cand - centroid[..., None, :],
                      torch.zeros_like(cand))
    ang = torch.where(valid, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], _BIG))
    pad = _SORT_N - _NUM_CAND
    ang = torch.cat([ang, ang.new_full(lead + (pad,), _BIG)], dim=-1)
    rel = torch.cat([rel, rel.new_zeros(lead + (pad, 2))], dim=-2)
    ang_s, rel_s = _bitonic_sort_by_key(ang, rel)
    # the invalid tail repeats the first vertex: those edges add nothing
    poly = torch.where((ang_s < _BIG / 2)[..., None], rel_s, rel_s[..., :1, :])
    area = polygon_area(poly)
    return torch.where(num_valid >= 3, area, torch.zeros_like(area))


def elementwise_quad_iou(c1, c2):
    """Elementwise IoU of aligned quads: (..., 4, 2) x (..., 4, 2) -> (...,)."""
    inter = quad_intersection_area(c1, c2)
    union = polygon_area(c1) + polygon_area(c2) - inter
    return inter / union.clamp_min(_EPS)
