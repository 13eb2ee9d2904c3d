"""Anchor-relative 7-DoF box decoding (counterpart of airv2x_tpu/ops/boxes.py):
hwl layout, xy scaled by the anchor BEV diagonal, z by the anchor height,
log-ratio sizes, additive yaw."""

from __future__ import annotations

import torch


def anchor_diagonal(anchors: torch.Tensor) -> torch.Tensor:
    """(..., 7) hwl anchors -> (...,) BEV diagonal sqrt(w^2 + l^2)."""
    return torch.sqrt(anchors[..., 4] ** 2 + anchors[..., 5] ** 2)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Decode (..., 7) deltas against aligned (..., 7) hwl anchors."""
    d = anchor_diagonal(anchors)
    x = deltas[..., 0] * d + anchors[..., 0]
    y = deltas[..., 1] * d + anchors[..., 1]
    z = deltas[..., 2] * anchors[..., 3] + anchors[..., 2]
    hwl = torch.exp(deltas[..., 3:6]) * anchors[..., 3:6]
    r = deltas[..., 6] + anchors[..., 6]
    return torch.cat([torch.stack([x, y, z], dim=-1), hwl, r[..., None]], dim=-1)
