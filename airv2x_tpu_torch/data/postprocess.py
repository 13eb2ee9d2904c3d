"""Decode of the model outputs (counterpart of airv2x_tpu/data/postprocess.py:
``decode_detections``, ``decode_late_fusion`` and ``decode_segmentation``).

Detection: logits -> boxes -> filters -> rotated NMS.

Top-k first: the P = min(2 * top_k, N) highest gated objectness scores are
selected before any box is decoded, and every candidate keeps a liveness
mask through the stages (objectness gate -> large-box / abnormal-z filters
-> rotated NMS -> range mask).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.boxes import decode_boxes
from airv2x_tpu_torch.ops.nms import rotated_nms


class Detections(NamedTuple):
    boxes: torch.Tensor  # (P, 7) decoded hwl boxes (cav frame)
    corners: torch.Tensor  # (P, 8, 3) projected corners (ego frame)
    scores: torch.Tensor  # (P,) objectness
    labels: torch.Tensor  # (P,) class ids (1-based)
    mask: torch.Tensor  # (P,) final keep mask
    nms_passes: int  # fixpoint passes the NMS took


def decode_detections(
    psm: torch.Tensor,
    rm: torch.Tensor,
    obj: torch.Tensor,
    anchors: torch.Tensor,
    transformation_matrix: torch.Tensor,
    lidar_range: torch.Tensor,
    *,
    num_class: int,
    obj_threshold: float,
    nms_thresh: float,
    top_k: int = 512,
) -> Detections:
    """Single-sample decode. psm (H, W, A*C), rm (H, W, 7A), obj (H, W, A);
    anchors (H, W, A, 7); lidar_range (6,)."""
    h, w, a = obj.shape
    n = h * w * a

    objness = torch.sigmoid(obj.float()).reshape(-1)  # (N,)
    flat_anchors = anchors.reshape(-1, 7)
    deltas = rm.float().reshape(-1, 7)

    p = min(2 * top_k, n)
    gated = torch.where(objness > obj_threshold, objness,
                        torch.full_like(objness, -torch.inf))
    p_scores, p_idx = torch.sort(gated, descending=True, stable=True)
    p_scores, p_idx = p_scores[:p], p_idx[:p]
    valid = p_scores > -torch.inf
    scores = torch.where(valid, p_scores, torch.zeros_like(p_scores))

    boxes = decode_boxes(deltas[p_idx], flat_anchors[p_idx])  # (P, 7)

    # class: sigmoid over (A, C), background column dropped, argmax + 1;
    # binary heads have no class columns
    if num_class > 1:
        cls = torch.sigmoid(psm.float().reshape(-1, num_class)[p_idx, 1:])
        labels = cls.argmax(-1).to(torch.int32) + 1
    else:
        labels = torch.ones(p, dtype=torch.int32, device=obj.device)

    corners = geo.boxes_to_corners_3d(boxes, order="hwl")  # (P, 8, 3)
    corners = geo.project_corners(corners, transformation_matrix)

    valid = valid & geo.keep_reasonable_boxes(
        corners, z_min=lidar_range[2], z_max=lidar_range[5]
    )
    keep, passes = rotated_nms(
        corners[:, :4, :2], scores, valid, nms_thresh, top_k=top_k
    )
    keep = keep & geo.mask_boxes_in_range_bev(corners, lidar_range)
    return Detections(boxes=boxes, corners=corners, scores=scores,
                      labels=labels, mask=keep, nms_passes=passes)


def decode_late_fusion(psm, rm, obj, anchors, pairwise_t, agent_mask,
                       lidar_range, *, num_class: int, obj_threshold: float,
                       nms_thresh: float, top_k: int = 512) -> Detections:
    """Late fusion's decode: every agent's own head outputs (leading axis L)
    decoded at every anchor, projected into the ego frame by its
    ``pairwise_t`` (L, 4, 4), gated by its objectness and ``agent_mask``
    (L,) and the box filters, then one rotated NMS (K2) over the L agents'
    pooled candidates. psm (L, H, W, A * num_class), rm (L, H, W, 7A), obj
    (L, H, W, A).

    Multiclass heads only, as in the JAX package: a binary head (one score
    per anchor) has no class columns, and there the class argmax has
    nothing to take (``num_class`` 1: ValueError) or the class reshape
    does not fit the logits (TypeError)."""
    l, h, w, a = obj.shape
    if num_class < 2:
        raise ValueError("late fusion needs class logits: the class argmax of "
                         f"num_class={num_class} has an empty sequence")
    if psm.shape[-1] != a * num_class:
        raise TypeError(f"late fusion: psm of {psm.shape[-1]} channels does "
                        f"not hold {a} anchors x {num_class} classes")
    objness = torch.sigmoid(obj.float()).reshape(l, -1)
    boxes = decode_boxes(rm.float().reshape(l, -1, 7),
                         anchors.reshape(-1, 7)[None])  # (L, N, 7)
    cls = torch.sigmoid(psm.float().reshape(l, -1, num_class))[..., 1:]
    labels = cls.argmax(-1).to(torch.int32) + 1
    corners = geo.boxes_to_corners_3d(boxes, order="hwl")  # (L, N, 8, 3)
    corners = geo.project_corners(corners.reshape(l, -1, 3), pairwise_t
                                  ).reshape(l, -1, 8, 3)
    valid = (objness > obj_threshold) & agent_mask.bool()[:, None]
    valid = valid & geo.keep_reasonable_boxes(
        corners, z_min=lidar_range[2], z_max=lidar_range[5])
    n = l * objness.shape[1]
    corners, scores = corners.reshape(n, 8, 3), objness.reshape(n)
    valid = valid.reshape(n)
    keep, passes = rotated_nms(corners[:, :4, :2], scores, valid, nms_thresh,
                               top_k=top_k)
    keep = keep & geo.mask_boxes_in_range_bev(corners, lidar_range)
    return Detections(boxes=boxes.reshape(n, 7), corners=corners, scores=scores,
                      labels=labels.reshape(n), mask=keep, nms_passes=passes)


def decode_segmentation(dynamic_logits: torch.Tensor,
                        static_logits: torch.Tensor):
    """Per-pixel class maps: argmax over the last axis of the f32 sigmoid of
    each (..., classes) logit map -> int32. Ties, as where the sigmoid
    saturates to 1, go to the lower index, as ``jnp.argmax`` does (and
    ``torch.argmax`` promises)."""
    return tuple(torch.sigmoid(t.float()).argmax(-1).to(torch.int32)
                 for t in (dynamic_logits, static_logits))
