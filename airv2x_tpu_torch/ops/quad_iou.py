"""K2, the pairwise rotated-quad IoU: kernel wrapper and its plain version.

Counterpart of airv2x_tpu/ops/pallas_iou.py (``_iou_tile_body`` through
``pairwise_quad_iou_pallas`` / ``pairwise_quad_iou_fused``). The CUDA kernel
is ``csrc/quad_iou.cu``; its note says what bounds it and how it is laid out.

``_separated`` is the plain form of the kernel's prefilter: pairs whose
axis-aligned boxes lie apart by more than the clip's tolerance can reach,
for which ``quad_iou_plain`` is exactly 0.0. ``iou_blocks`` mirrors the
kernel's block -> tile map.

Both versions compute the sort-free edge-integral (Green's theorem)
intersection area: each directed edge of one quad is clipped to the other
quad's four half-planes and contributes 1/2 * cross(p, q) * dt; pieces
collinear with a boundary get weight 1/2, so identical quads give exactly 1
and edge-sharing quads exactly 0. Pairs are centred at A's first corner.
A quad whose area is within the tolerance tol2 of zero (a box of zero
width, as random weights decode) has no reliable half-planes: the clip
would weigh every edge of the other quad as collinear and report an IoU
near 1 with any quad, so its intersection is taken as 0, which moves the
IoU by at most tol2 / union.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch import kernels

_EPS = 1e-8  # division guard
_TOL = 1e-4  # cross-product tolerance (length^2), scaled per pair by area
_BIG = 1e9
TILE = 16  # csrc/quad_iou.cu's tile: T x T pairs per block
# the prefilter's rounding allowance: 64 ulps (2^-24 relative) of the
# largest absolute coordinate of the pair, plus one
_ULPS = 64 * 2.0 ** -24
# a corner whose turn is below 2^-10 of its edges' product (an angle under
# ~0.06 degrees) makes the quad ineligible for the prefilter
_MIN_TURN = 2.0 ** -10


def quad_iou(c1: torch.Tensor, c2: torch.Tensor, *, triangular: bool = False):
    """(N, 4, 2) x (M, 4, 2) f32 corner quads -> (N, M) f32 IoU.

    With ``triangular=True`` only pairs i < j are guaranteed: the kernel may
    zero-fill tiles that lie wholly below the diagonal, as greedy NMS reads
    only pairs where the row outranks the column. The plain version always
    computes every pair.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    for name, t in (("c1", c1), ("c2", c2)):
        if t.dim() != 3 or tuple(t.shape[1:]) != (4, 2):
            raise ValueError(f"quad_iou: {name} must be (K, 4, 2), got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise ValueError(f"quad_iou: {name} must be float32, got {t.dtype}")
        if t.device != c1.device:
            raise ValueError("quad_iou: c1 and c2 must share a device")
    if c1.device.type == "cpu":
        return quad_iou_plain(c1, c2)
    if c1.device.type != "cuda":
        raise ValueError(f"quad_iou: unsupported device {c1.device}")
    if not (c1.is_contiguous() and c2.is_contiguous()):
        raise ValueError("quad_iou: inputs must be contiguous")
    n, m = c1.shape[0], c2.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=c1.device)
    with torch.cuda.device(c1.device):
        err = kernels.lib("quad_iou").quad_iou(
            c1.data_ptr(), c2.data_ptr(), out.data_ptr(), n, m,
            int(triangular), kernels.current_stream(),
        )
    kernels.check("quad_iou", err)
    kernels.LAUNCHES["quad_iou"] += 1
    return out


def _signed_area(xs, ys):
    s = None
    for k in range(4):
        kk = (k + 1) % 4
        t = xs[k] * ys[kk] - xs[kk] * ys[k]
        s = t if s is None else s + t
    return 0.5 * s


def _pieces(xs_p, ys_p, xs_h, ys_h, sgn_h, tol2):
    """Sum over the edges of P of cross(p, q) * dt * w, each edge clipped to
    the inside of H (orientation sign sgn_h)."""
    total = None
    for e in range(4):
        px, py = xs_p[e], ys_p[e]
        qx, qy = xs_p[(e + 1) % 4], ys_p[(e + 1) % 4]
        dx, dy = qx - px, qy - py
        cross_e = px * qy - py * qx
        tlo = thi = emp = coll = None
        for k in range(4):
            b0x, b0y = xs_h[k], ys_h[k]
            ex = xs_h[(k + 1) % 4] - b0x
            ey = ys_h[(k + 1) % 4] - b0y
            num = sgn_h * (ex * (py - b0y) - ey * (px - b0x))
            den = sgn_h * (ex * dy - ey * dx)
            gt = den - tol2 >= 0  # entering constraint
            lt = -den - tol2 >= 0  # leaving constraint
            mid = ~(gt | lt)  # parallel
            tb = -num / torch.where(mid, torch.ones_like(den), den)
            tlo_k = torch.where(gt, tb, torch.full_like(tb, -_BIG))
            thi_k = torch.where(lt, tb, torch.full_like(tb, _BIG))
            emp_k = mid & (-num - tol2 >= 0)  # parallel and outside
            coll_k = mid & (tol2 - num.abs() >= 0)  # on the boundary
            if tlo is None:
                tlo, thi, emp, coll = tlo_k, thi_k, emp_k, coll_k
            else:
                tlo = torch.maximum(tlo, tlo_k)
                thi = torch.minimum(thi, thi_k)
                emp = emp | emp_k
                coll = coll | coll_k
        t0 = tlo.clamp_min(0.0)
        t1 = thi.clamp_max(1.0)
        dt = torch.where(emp, torch.zeros_like(t0), (t1 - t0).clamp_min(0.0))
        w = torch.where(coll, 0.5, 1.0)
        contrib = cross_e * (dt * w)
        total = contrib if total is None else total + contrib
    return total


def quad_iou_plain(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """The same edge integral on broadcast (N, M) tensors."""
    x1 = [c1[:, k, 0:1] for k in range(4)]  # (N, 1)
    y1 = [c1[:, k, 1:2] for k in range(4)]
    x2 = [c2[None, :, k, 0] for k in range(4)]  # (1, M)
    y2 = [c2[None, :, k, 1] for k in range(4)]
    ox, oy = x1[0], y1[0]
    xa = [v - ox for v in x1]
    ya = [v - oy for v in y1]
    xb = [v - ox for v in x2]
    yb = [v - oy for v in y2]
    sa = _signed_area(xa, ya).expand(c1.shape[0], c2.shape[0])
    sb = _signed_area(xb, yb)
    sgn_a, sgn_b = torch.sign(sa), torch.sign(sb)
    aa, ab = sa.abs(), sb.abs()
    tol2 = _TOL * (torch.maximum(aa, ab) + 1.0)
    inter = 0.5 * (
        _pieces(xa, ya, xb, yb, sgn_b, tol2) * sgn_a
        + _pieces(xb, yb, xa, ya, sgn_a, tol2) * sgn_b
    ).abs()
    inter = torch.where((aa <= tol2) | (ab <= tol2), 0.0, inter)
    union = aa + ab - inter
    return inter / union.clamp_min(_EPS)


def _quad_terms(c):
    """Per quad of (K, 4, 2) ``c``: its axis-aligned box (xmin, xmax, ymin,
    ymax), |signed area|, 1 / its shortest edge, corner factor kappa = max over the
    corners of 2 L_k L_k+1 / |turn_k| (>= 1 / sin(angle / 2)), largest
    absolute coordinate, and whether the prefilter may use it: every
    coordinate finite and the quad strictly convex, every turn of the
    area's sign and at least 2^-10 of its edges' product."""
    x, y = c[..., 0], c[..., 1]
    ex, ey = x.roll(-1, 1) - x, y.roll(-1, 1) - y
    length = torch.sqrt(ex * ex + ey * ey)
    turn = ex * ey.roll(-1, 1) - ey * ex.roll(-1, 1)
    x0, y0 = x[:, :1], y[:, :1]
    area = _signed_area([x[:, k] - x0[:, 0] for k in range(4)],
                        [y[:, k] - y0[:, 0] for k in range(4)])
    lprod = length * length.roll(-1, 1)
    kappa = (2.0 * lprod / turn.abs()).amax(1)
    convex = ((turn * torch.sign(area)[:, None] >= _MIN_TURN * lprod)
              & (turn != 0)).all(1)
    ok = torch.isfinite(c).all(2).all(1) & convex
    scale = c.abs().amax((1, 2))
    return (x.amin(1), x.amax(1), y.amin(1), y.amax(1), area.abs(),
            1.0 / length.amin(1), kappa, scale, ok)


def _separated(c1, c2):
    """(N, M) bool: pairs the kernel's prefilter rejects, for which
    ``quad_iou_plain`` is exactly 0.0.

    A point of an edge of one quad that the clip keeps lies inside every
    half-plane of the other quad up to eta = 2 tol2 / L_min past its edge
    line (a constraint within tol2 of parallel is dropped unless the edge
    starts tol2 outside, and changes by under tol2 along the edge), plus
    rounding of a few ulps of the coordinates; inside a convex quad with
    every side moved out by eta, a point lies within kappa x eta of the
    quad. So a gap between the axis-aligned boxes beyond
    max(kappa) x (eta + 64 ulps of the largest coordinate) leaves every
    clipped interval empty, and the IoU is +0.0. Written as
    ``gap > margin``, a NaN falls through to the full computation."""
    row = [t[:, None] for t in _quad_terms(c1)]
    col = [t[None, :] for t in _quad_terms(c2)]
    gap = torch.maximum(torch.maximum(col[0] - row[1], row[0] - col[1]),
                        torch.maximum(col[2] - row[3], row[2] - col[3]))
    return row[8] & col[8] & (gap > _margin(row, col))


def _margin(a, b):
    """The prefilter's margin between quads of ``_quad_terms`` a and b
    (broadcast against each other)."""
    tol2 = _TOL * (torch.maximum(a[4], b[4]) * 1.001 + 1.0)
    return torch.maximum(a[6], b[6]) * (
        2.0 * tol2 * torch.maximum(a[5], b[5])
        + _ULPS * (torch.maximum(a[7], b[7]) + 1.0))


def iou_blocks(n: int, m: int, triangular: bool, tile: int = TILE):
    """The kernel's blocks in launch order, each as (computed tile,
    zero-filled tile), a tile being (row block, column block) or None.

    Full: one block per tile of the (n, m) output. Triangular: one block per
    tile pair (bi <= bj) of an S x S tile grid, S covering both n and m; it
    computes tile (bi, bj) and, off the diagonal, zero-fills its mirror (bj,
    bi), each where it lies inside the output: every tile is written once
    and every pair i < j lies in a computed tile."""
    tn, tm = -(-n // tile), -(-m // tile)
    if not triangular:
        return [((k // tm, k % tm), None) for k in range(tn * tm)]
    s = max(tn, tm)
    out = []
    for k in range(s * (s + 1) // 2):
        bi, rem = 0, k
        while rem >= s - bi:
            rem -= s - bi
            bi += 1
        bj = bi + rem
        out.append(((bi, bj) if bi < tn and bj < tm else None,
                    (bj, bi) if bi < bj and bj < tn and bi < tm else None))
    return out
