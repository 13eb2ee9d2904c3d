"""Anchor grid generation and anchor-target assignment (counterpart of
airv2x_tpu/ops/anchors.py).

Assignment follows the JAX package's rules, which reproduce the reference's
label generator:
  * standup-box IoU in the +1 pixel convention (``geometry.aligned_iou_2d``);
  * positives: anchors with IoU > pos_threshold against any gt, plus each
    gt's best-overlap anchor (forced positive, if its IoU > 0);
  * an anchor matching several gts takes the lowest-index gt among its
    threshold matches if any, else the lowest-index gt among its forced
    matches (first occurrence, ``argmax`` of an int cast);
  * negatives: anchors with every valid gt IoU < neg_threshold, minus forced
    positives (but NOT minus threshold positives, as in the reference).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.boxes import encode_boxes


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


def anchor_standup_boxes(anchors: np.ndarray) -> np.ndarray:
    """(H*W*A, 4) f32 standup boxes of the anchor grid (host, once)."""
    flat = torch.from_numpy(np.ascontiguousarray(anchors.reshape(-1, 7)))
    return geo.corners_to_standup_2d(geo.boxes_to_corners_bev(flat)).numpy()


class AnchorTargets(NamedTuple):
    pos_equal_one: torch.Tensor  # (H, W, A) float
    neg_equal_one: torch.Tensor  # (H, W, A) float
    targets: torch.Tensor  # (H, W, A * 7) float
    cls_labels: torch.Tensor  # (H, W, A) int32


def assign_targets(
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    gt_class_ids: torch.Tensor,
    anchors: torch.Tensor,
    anchor_standup: torch.Tensor,
    *,
    pos_threshold: float,
    neg_threshold: float,
) -> AnchorTargets:
    """Anchor targets of one sample.

    gt_boxes (G, 7) hwl boxes padded to capacity; gt_mask (G,) validity;
    gt_class_ids (G,) int; anchors (H, W, A, 7); anchor_standup (H*W*A, 4).
    """
    h, w, a = anchors.shape[:3]
    na, ng = anchor_standup.shape[0], gt_boxes.shape[0]
    flat_anchors = anchors.reshape(na, 7)

    gt_standup = geo.corners_to_standup_2d(geo.boxes_to_corners_bev(gt_boxes))
    iou = geo.aligned_iou_2d(anchor_standup, gt_standup)  # (Na, G)
    iou = torch.where(gt_mask[None, :], iou, torch.full_like(iou, -1.0))

    # forced positives: each valid gt's best anchor (first on ties)
    best_iou, best_anchor = iou.amax(dim=0), iou.argmax(dim=0)
    force_valid = gt_mask & (best_iou > 0)
    force = torch.zeros((na, ng), dtype=torch.bool, device=iou.device)
    cols = torch.arange(ng, device=iou.device)
    force[best_anchor[force_valid], cols[force_valid]] = True

    thresh_pos = iou > pos_threshold
    anchor_pos = (thresh_pos | force).any(dim=1)
    first_thresh = thresh_pos.to(torch.int32).argmax(dim=1)
    first_force = force.to(torch.int32).argmax(dim=1)
    chosen_gt = torch.where(thresh_pos.any(dim=1), first_thresh, first_force)

    # padded gt slots vacuously pass, so no valid gt makes every anchor
    # negative
    below = (iou < neg_threshold) | ~gt_mask[None, :]
    anchor_neg = below.all(dim=1) & ~force.any(dim=1)

    tgt = encode_boxes(gt_boxes[chosen_gt], flat_anchors)
    tgt = torch.where(anchor_pos[:, None], tgt, torch.zeros_like(tgt))
    cls = torch.where(anchor_pos, gt_class_ids[chosen_gt].to(torch.int32),
                      torch.zeros_like(chosen_gt, dtype=torch.int32))
    return AnchorTargets(
        pos_equal_one=anchor_pos.reshape(h, w, a).to(torch.float32),
        neg_equal_one=anchor_neg.reshape(h, w, a).to(torch.float32),
        targets=tgt.reshape(h, w, a * 7).to(torch.float32),
        cls_labels=cls.reshape(h, w, a),
    )
