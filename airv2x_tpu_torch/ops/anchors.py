"""Anchor grid generation (copy of airv2x_tpu/ops/anchors.py
``generate_anchor_grid``; target assignment is training and waits)."""

from __future__ import annotations

import numpy as np


def generate_anchor_grid(anchor_args: dict) -> np.ndarray:
    """Build the (H/stride, W/stride, num_anchor, 7) hwl anchor grid (host,
    once): anchor centres on a linspace inset by one voxel from the lidar
    range, z fixed at -1, one anchor per rotation in ``r`` (degrees)."""
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    rotations = [np.radians(r) for r in anchor_args["r"]]
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    lr = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(lr[0] + vw, lr[3] - vw, W // stride)
    y = np.linspace(lr[1] + vh, lr[4] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)  # (H/s, W/s)

    num = len(rotations)
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)
    ww = np.full_like(cx, w)
    ll = np.full_like(cx, l)
    hh = np.full_like(cx, h)
    rr = np.stack([np.full_like(cx[..., 0], r) for r in rotations], axis=-1)

    anchors = np.stack([cx, cy, cz, hh, ww, ll, rr], axis=-1)
    return anchors.astype(np.float32)
