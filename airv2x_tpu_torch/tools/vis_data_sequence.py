"""Render a data sequence to BEV PNG frames (counterpart of
airv2x_tpu/tools/vis_data_sequence.py).

    python -m airv2x_tpu_torch.tools.vis_data_sequence --hypes_yaml cfg.yaml
        --output_dir <dir> [--frames 10] [--root_dir dataset/...] [--seed 0]

Per frame: each agent type's points in its colour and the gt boxes, on a
BEV canvas, as ``frame_{i:04d}.png``. The frames are synthetic
``make_scene`` scenes (8 objects), or the AirV2X split at ``--root_dir``
(the JAX tool imports a dataset class its package does not have there).
Runs on the host only: there is no model.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.ops.geometry import boxes_to_corners_bev
from airv2x_tpu_torch.visualization.bev_canvas import visualize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BEV data-sequence renderer")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--root_dir", default=None,
                   help="real dataset split dir; synthetic when omitted")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _frame_arrays(batch, gt, layout):
    """({agent type: (P, 3) points}, (N, 4, 2) gt corners or None)."""
    pts = np.asarray(batch["points"])
    mask = np.asarray(batch["points_mask"]).astype(bool)
    am = np.asarray(batch["agent_mask"]).astype(bool)
    if pts.ndim == 4 and pts.shape[0] == 1:  # strip the batch axis
        pts, mask, am = pts[0], mask[0], am[0]
    if pts.ndim == 4:  # temporal (T, L, N, 4): draw the current frame
        pts, mask, am = pts[-1], mask[-1], am[-1]

    agent_points = {}
    for t in ("vehicle", "rsu", "drone"):
        sl = layout.slots(t)
        rows = [pts[i][mask[i]] for i in range(sl.start, sl.stop)
                if i < len(am) and am[i]]
        rows = [r for r in rows if len(r)]
        if rows:
            agent_points[t] = np.concatenate(rows, 0)[:, :3]

    corners = None
    boxes = gt.get("boxes") if isinstance(gt, dict) else None
    if boxes is not None and len(boxes):
        boxes = np.asarray(boxes)
        valid = np.abs(boxes).sum(-1) > 0
        if valid.any():
            corners = boxes_to_corners_bev(torch.from_numpy(boxes[valid])).numpy()
    return agent_points, corners


def main(argv=None) -> list:
    """Render; returns the written paths."""
    opt = parse_args(argv)
    hypes = load_yaml(opt.hypes_yaml)
    layout = SlotLayout.from_args(hypes["model"]["args"])
    lidar_range = hypes["preprocess"]["cav_lidar_range"]
    os.makedirs(opt.output_dir, exist_ok=True)

    if opt.root_dir:
        from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset

        ds = AirV2XDataset(hypes, opt.root_dir, train=False)
        frames = (ds[i] for i in range(min(opt.frames, len(ds))))
    else:
        rng = np.random.default_rng(opt.seed)
        frames = (make_scene(rng, layout, num_objects=8,
                             points_per_agent=int(hypes["preprocess"].get("max_points", 8192)),
                             lidar_range=lidar_range)
                  for _ in range(opt.frames))

    written = []
    for i, (batch, gt) in enumerate(frames):
        agent_points, corners = _frame_arrays(batch, gt, layout)
        out = os.path.join(opt.output_dir, f"frame_{i:04d}.png")
        visualize(pred_corners=None, gt_corners=corners, points=None,
                  lidar_range=lidar_range, save_path=out, agent_points=agent_points)
        print(f"[vis] {out}")
        written.append(out)
    print(f"[vis] wrote {len(written)} frames to {opt.output_dir}")
    return written


if __name__ == "__main__":
    main()
