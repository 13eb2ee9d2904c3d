"""Synthetic multi-agent LiDAR scene generator (copy of
airv2x_tpu/data/synthetic.py ``make_scene``).

numpy only, seeded by the caller's ``np.random.Generator``: the same seed
gives bit-identical arrays to the JAX package's generator, so both packages
can be fed one scene. ``batch_to_torch`` moves a batch onto the device.
"""

from __future__ import annotations

import numpy as np
import torch

from airv2x_tpu_torch.models.base import AGENT_TYPES, SlotLayout
from airv2x_tpu_torch.utils.device import resolve_device


def _box_surface_points(rng, box, n):
    """Sample n points on the vertical faces + top of an hwl box."""
    x, y, z, h, w, l, yaw = box
    # local frame: l along x, w along y, h along z
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    face = rng.integers(0, 5, size=n)
    pts = np.zeros((n, 3))
    pts[:, 0] = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u[:, 0])) * l
    pts[:, 1] = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u[:, 1])) * w
    zu = rng.uniform(-0.5, 0.5, size=n)
    pts[:, 2] = np.where(face == 4, 0.5, zu) * h
    c, s = np.cos(yaw), np.sin(yaw)
    rx = c * pts[:, 0] - s * pts[:, 1] + x
    ry = s * pts[:, 0] + c * pts[:, 1] + y
    rz = pts[:, 2] + z
    return np.stack([rx, ry, rz], axis=-1)


def make_scene(
    rng: np.random.Generator,
    layout: SlotLayout,
    *,
    num_objects: int = 12,
    num_agents: dict | None = None,
    points_per_agent: int = 8192,
    lidar_range=(-140.8, -40, -3, 140.8, 40, 1),
    max_boxes: int = 100,
    pts_per_box: int = 120,
):
    """Build one sample. Returns (batch_arrays, gt dict) — all numpy."""
    num_agents = num_agents or {"vehicle": 2, "rsu": 1, "drone": 1}
    L = layout.total
    n = points_per_agent

    xr = (lidar_range[0] * 0.7, lidar_range[3] * 0.7)
    yr = (lidar_range[1] * 0.7, lidar_range[4] * 0.7)

    boxes = np.zeros((max_boxes, 7), np.float32)
    classes = np.zeros((max_boxes,), np.int32)
    k = min(num_objects, max_boxes)
    boxes[:k, 0] = rng.uniform(*xr, k)
    boxes[:k, 1] = rng.uniform(*yr, k)
    boxes[:k, 2] = rng.uniform(-1.2, -0.8, k)
    boxes[:k, 3] = rng.uniform(1.4, 1.8, k)  # h
    boxes[:k, 4] = rng.uniform(1.5, 1.9, k)  # w
    boxes[:k, 5] = rng.uniform(3.5, 4.5, k)  # l
    boxes[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    classes[:k] = rng.integers(1, 7, k)
    box_mask = np.arange(max_boxes) < k

    # agent viewpoints (ego-frame xy) per type
    agent_pos = np.zeros((L, 2), np.float32)
    agent_mask = np.zeros((L,), bool)
    prior = np.zeros((L, 3), np.float32)
    for t in AGENT_TYPES:
        sl = layout.slots(t)
        cnt = min(num_agents.get(t, 0), sl.stop - sl.start)
        for j in range(cnt):
            slot = sl.start + j
            agent_mask[slot] = True
            if t == "vehicle" and j == 0:
                agent_pos[slot] = 0.0  # ego
            else:
                agent_pos[slot, 0] = rng.uniform(*xr)
                agent_pos[slot, 1] = rng.uniform(*yr)
            prior[slot, 0] = rng.uniform(0, 20)  # velocity
            prior[slot, 1] = 0.0  # time delay
            prior[slot, 2] = float(t == "rsu")

    points = np.zeros((L, n, 4), np.float32)
    points_mask = np.zeros((L, n), bool)
    com_range = {"vehicle": 120.0, "rsu": 120.0, "drone": 180.0}
    for slot in range(L):
        if not agent_mask[slot]:
            continue
        t = next(
            tt for tt in AGENT_TYPES
            if layout.slots(tt).start <= slot < layout.slots(tt).stop
        )
        buf = []
        for b in range(k):
            d = np.linalg.norm(boxes[b, :2] - agent_pos[slot])
            if d > com_range[t]:
                continue
            density = max(0.15, min(1.0, 40.0 / max(d, 1.0)))
            m = max(4, int(pts_per_box * density * rng.uniform(0.5, 1.0)))
            buf.append(_box_surface_points(rng, boxes[b], m))
        n_ground = n // 4
        gx = rng.uniform(lidar_range[0], lidar_range[3], n_ground)
        gy = rng.uniform(lidar_range[1], lidar_range[4], n_ground)
        gz = rng.uniform(-2.0, -1.8, n_ground)
        buf.append(np.stack([gx, gy, gz], axis=-1))
        pts = np.concatenate(buf, axis=0)
        if len(pts) > n:
            pts = pts[rng.permutation(len(pts))[:n]]
        m = len(pts)
        points[slot, :m, :3] = pts
        points[slot, :m, 3] = rng.uniform(0, 1, m)
        points_mask[slot, :m] = True

    pairwise_t = np.broadcast_to(np.eye(4, dtype=np.float32), (L, 4, 4)).copy()
    pairwise_t_full = np.broadcast_to(
        np.eye(4, dtype=np.float32), (L, L, 4, 4)
    ).copy()

    batch = {
        "points": points,
        "points_mask": points_mask,
        "agent_mask": agent_mask,
        "pairwise_t": pairwise_t,
        "pairwise_t_full": pairwise_t_full,
        "prior_encoding": prior,
    }
    gt = {"boxes": boxes, "mask": box_mask, "classes": classes}
    return batch, gt


def batch_to_torch(batch: dict, device="cuda") -> dict:
    """numpy batch arrays -> tensors on ``device`` (bool stays bool)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
