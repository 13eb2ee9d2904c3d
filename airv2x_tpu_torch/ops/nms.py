"""Greedy rotated NMS over a fixed pool of candidates (counterpart of
airv2x_tpu/ops/nms.py:rotated_nms).

top-k by score (stable, so ties keep the lower index first, as
``jax.lax.top_k`` does), one k x k upper-triangular IoU matrix from K2
(``ops/quad_iou.py``), then greedy suppression as the antitone fixpoint
f(A) = {j : valid_j and no kept i < j in A overlaps j}. Iterating from the
valid set converges to the greedy keep set in O(longest suppression chain)
passes; each pass is one masked (k, k) reduction and one host check.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.ops.quad_iou import quad_iou


def rotated_nms(corners_bev, scores, valid, iou_threshold: float,
                top_k: int = 1024):
    """corners_bev (N, 4, 2), scores (N,), valid (N,) bool.

    Returns (keep (N,) bool, passes): ``keep`` is False for suppressed and
    padding rows; ``passes`` counts the fixpoint steps taken.
    """
    n = scores.shape[0]
    k = min(top_k, n)
    masked = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    top_scores, top_idx = torch.sort(masked, descending=True, stable=True)
    top_scores, top_idx = top_scores[:k], top_idx[:k]
    top_corners = corners_bev[top_idx].to(torch.float32).contiguous()
    top_valid = top_scores > -torch.inf

    iou = quad_iou(top_corners, top_corners, triangular=True)

    # over[i, j]: the better-ranked box i suppresses j if i is kept
    rank = torch.arange(k, device=scores.device)
    earlier = rank[:, None] < rank[None, :]
    over = (iou > iou_threshold) & earlier & top_valid[:, None]

    def step(alive):
        return top_valid & ~(over & alive[:, None]).any(0)

    prev, alive, passes = top_valid, step(top_valid), 1
    while passes <= k and bool((alive != prev).any()):
        prev, alive = alive, step(alive)
        passes += 1

    keep = torch.zeros(n, dtype=torch.bool, device=scores.device)
    keep[top_idx] = alive
    return keep & valid, passes
