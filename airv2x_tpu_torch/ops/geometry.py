"""Box geometry on tensors (counterpart of airv2x_tpu/ops/geometry.py).

Boxes are 7-DoF ``[x, y, z, s3, s4, s5, yaw]`` with the size triplet in
``hwl`` or ``lwh`` order. Corners 0-3 are the bottom face, 4-7 the top face,
with corner k+4 above corner k. Everything broadcasts over leading dims.
"""

from __future__ import annotations

import torch

# Unit-cube template: (8, 3) offsets in the box frame (l along x, w along y,
# h along z), halved.
_CORNER_TEMPLATE = [
    [1, -1, -1],
    [1, 1, -1],
    [-1, 1, -1],
    [-1, -1, -1],
    [1, -1, 1],
    [1, 1, 1],
    [-1, 1, 1],
    [-1, -1, 1],
]


def boxes_to_lwh_order(boxes: torch.Tensor, order: str) -> torch.Tensor:
    """Reorder the size columns of (..., 7) boxes to l, w, h."""
    if order == "lwh":
        return boxes
    if order == "hwl":
        return boxes[..., [0, 1, 2, 5, 4, 3, 6]]
    raise ValueError(f"unknown box order: {order}")


def rotate_points_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate (..., N, 3) points by (...,) yaw angles about +z, elementwise."""
    c, s = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=-1)


def boxes_to_corners_3d(boxes: torch.Tensor, order: str = "hwl") -> torch.Tensor:
    """(..., 7) boxes -> (..., 8, 3) corners."""
    b = boxes_to_lwh_order(boxes, order)
    tmpl = torch.tensor(_CORNER_TEMPLATE, dtype=b.dtype, device=b.device) * 0.5
    corners = b[..., None, 3:6] * tmpl  # (..., 8, 3)
    corners = rotate_points_z(corners, b[..., 6])
    return corners + b[..., None, 0:3]


def project_corners(corners: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Rigid-project (..., K, 3) corners with a (..., 4, 4) transform.

    Written as elementwise products and a sum over 3 terms, so the result is
    full f32 whatever the card's matmul precision setting is.
    """
    rot = transform[..., None, :3, :3]  # (..., 1, 3, 3)
    trans = transform[..., None, :3, 3]  # (..., 1, 3)
    return (corners[..., None, :] * rot).sum(-1) + trans


def mask_boxes_in_range_bev(corners: torch.Tensor, limit_range) -> torch.Tensor:
    """(..., N, 8, 3) corners -> (..., N) bool: all BEV corners inside range."""
    lo = torch.as_tensor(limit_range[:2], dtype=corners.dtype, device=corners.device)
    hi = torch.as_tensor(limit_range[3:5], dtype=corners.dtype, device=corners.device)
    ok = (corners[..., :2] >= lo).all(-1) & (corners[..., :2] <= hi).all(-1)
    return ok.all(-1)


def keep_reasonable_boxes(
    corners: torch.Tensor, z_min: float, z_max: float, max_xy: float = 6.0
) -> torch.Tensor:
    """(..., N, 8, 3) -> (..., N) bool: drops over-large boxes and boxes with
    an abnormal z extent."""
    x_len = corners[..., 0].amax(-1) - corners[..., 0].amin(-1)
    y_len = corners[..., 1].amax(-1) - corners[..., 1].amin(-1)
    z_lo = corners[..., 2].amin(-1)
    z_hi = corners[..., 2].amax(-1)
    small = (x_len <= max_xy) & (y_len <= max_xy)
    z_ok = (z_lo >= z_min) & (z_hi <= z_max)
    return small & z_ok
