"""World-level data augmentation (host, numpy; copy of
airv2x_tpu/data/augment.py).

Random world flip, rotation about z and scaling, applied jointly to points
and gt boxes with the caller's ``np.random.Generator``, so one seed draws the
same numbers as the JAX package.
"""

from __future__ import annotations

import numpy as np


def random_world_flip(points, boxes, rng, along=("x",)):
    """Random axis flips, reference augment_utils semantics:
    along 'x' negates y and heading (:9-26); along 'y' negates x and maps
    heading to -(heading + pi) (:28-45)."""
    if "x" in along and rng.uniform() < 0.5:
        points = points.copy()
        boxes = boxes.copy()
        points[..., 1] = -points[..., 1]
        boxes[..., 1] = -boxes[..., 1]
        boxes[..., 6] = -boxes[..., 6]
    if "y" in along and rng.uniform() < 0.5:
        points = points.copy()
        boxes = boxes.copy()
        points[..., 0] = -points[..., 0]
        boxes[..., 0] = -boxes[..., 0]
        boxes[..., 6] = -(boxes[..., 6] + np.pi)
    return points, boxes


def random_world_rotation(points, boxes, rng, rot_range=(-0.7854, 0.7854)):
    ang = rng.uniform(*rot_range)
    c, s = np.cos(ang), np.sin(ang)
    points = points.copy()
    boxes = boxes.copy()
    x, y = points[..., 0].copy(), points[..., 1].copy()
    points[..., 0] = c * x - s * y
    points[..., 1] = s * x + c * y
    bx, by = boxes[..., 0].copy(), boxes[..., 1].copy()
    boxes[..., 0] = c * bx - s * by
    boxes[..., 1] = s * bx + c * by
    boxes[..., 6] = boxes[..., 6] + ang
    return points, boxes


def random_world_scaling(points, boxes, rng, scale_range=(0.95, 1.05)):
    s = rng.uniform(*scale_range)
    points = points.copy()
    boxes = boxes.copy()
    points[..., :3] *= s
    boxes[..., :3] *= s
    boxes[..., 3:6] *= s
    return points, boxes


_AUGMENTORS = {
    "random_world_flip": lambda p, b, rng, cfg: random_world_flip(
        p, b, rng, along=[a.lower() for a in cfg.get("ALONG_AXIS_LIST", ["x"])]
    ),
    "random_world_rotation": lambda p, b, rng, cfg: random_world_rotation(
        p, b, rng, rot_range=cfg.get("WORLD_ROT_ANGLE", (-0.7854, 0.7854))
    ),
    "random_world_scaling": lambda p, b, rng, cfg: random_world_scaling(
        p, b, rng, scale_range=cfg.get("WORLD_SCALE_RANGE", (0.95, 1.05))
    ),
}


class DataAugmentor:
    """Config-driven augmentation queue (data_augmentor.py:15-128 twin)."""

    def __init__(self, aug_config: list, train: bool = True):
        self.queue = []
        self.train = train
        for cfg in aug_config or []:
            name = cfg["NAME"]
            if name not in _AUGMENTORS:
                raise KeyError(f"unknown augmentor {name}")
            self.queue.append((name, cfg))

    def __call__(self, points: np.ndarray, boxes: np.ndarray, rng):
        """points (..., N, 3+) and boxes (..., 7) in a COMMON (ego/world)
        frame; returns augmented copies."""
        if not self.train:
            return points, boxes
        for name, cfg in self.queue:
            points, boxes = _AUGMENTORS[name](points, boxes, rng, cfg)
        return points, boxes
