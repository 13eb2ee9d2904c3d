"""Temporal alignment of ego history (counterpart of
airv2x_tpu/models/fusion/temporal.py: ``warp_history_to_current``; the
temporal fusions of the other models wait). Channels-last."""

from __future__ import annotations

from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


def warp_history_to_current(feats, delta_t, discrete_ratio: float,
                            downsample_rate: float):
    """feats (B, T, H, W, C) ego features of T frames; delta_t (B, T, 4, 4)
    each frame's ego pose in the current ego frame -> the features warped
    into the current frame (f32 sampling weights: a bf16 map comes out
    f32)."""
    h, w = feats.shape[2], feats.shape[3]
    aff = normalized_pairwise_affine(delta_t, h, w, discrete_ratio,
                                     downsample_rate)
    return warp_affine_normalized(feats, aff)
