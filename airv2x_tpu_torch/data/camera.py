"""The seg task's BEV label readers (counterpart of the label half of
airv2x_tpu/data/camera.py: ``_binary_label_map`` and ``load_seg_labels``).

Each agent dir of the AirV2X dataset holds 7 dynamic and 3 static BEV
layer masks as PNGs. The camera image loader of the JAX module is not
ported (ROADMAP §1 item 3).
"""

from __future__ import annotations

import os

import numpy as np

DYNAMIC_SEG_FILES = tuple(f"map_dynamic_bev_layer_{i}.png" for i in range(7))
STATIC_SEG_FILES = (
    "map_static_background.png",
    "map_static_lane.png",
    "map_static_road.png",
)


def _binary_label_map(agent_dir: str, filenames) -> np.ndarray | None:
    """Stack threshold (> 10) masks into a class-id map, the last layer
    winning; transposed and column-flipped as the reference's
    ``basedataset._wrap_segmentation_map``. None when a file is missing."""
    from PIL import Image

    masks = []
    for fn in filenames:
        p = os.path.join(agent_dir, fn)
        if not os.path.isfile(p):
            return None
        with Image.open(p) as img:
            arr = np.asarray(img.convert("L"))
        masks.append((arr > 10).astype(np.uint8))
    label = np.zeros_like(masks[0])
    for idx, m in enumerate(masks):
        label[m == 1] = idx
    label = label.T
    return np.ascontiguousarray(label[:, ::-1])


def load_seg_labels(agent_dir: str):
    """(dynamic (H, W) uint8 | None, static (H, W) uint8 | None)."""
    return (
        _binary_label_map(agent_dir, DYNAMIC_SEG_FILES),
        _binary_label_map(agent_dir, STATIC_SEG_FILES),
    )
