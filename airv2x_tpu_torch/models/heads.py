"""Task heads (counterpart of airv2x_tpu/models/heads.py): detection
(cls / reg / obj 1x1 convs) and BEV segmentation. Detection outputs stay
NCHW here and the model turns them NHWC at its public output; the
segmentation head returns NHWC logits, as the JAX package does."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.ops.warp import grid_sample_bilinear


class DetectionHeads(nn.Module):
    def __init__(self, in_ch: int, anchor_number: int, num_class: int):
        super().__init__()
        self.cls_head = nn.Conv2d(in_ch, anchor_number * num_class, 1)
        self.reg_head = nn.Conv2d(in_ch, 7 * anchor_number, 1)
        self.obj_head = nn.Conv2d(in_ch, anchor_number, 1)

    def forward(self, x):
        return {"psm": self.cls_head(x), "rm": self.reg_head(x),
                "obj": self.obj_head(x)}


def _bilinear_resize(x, hw: int):
    """(..., h, w, C) -> (..., hw, hw, C) by the gather-based sampler at
    half-pixel centres clamped to the border (edge semantics, no
    antialias), as the JAX package's ``_bilinear_resize``."""
    h, w = x.shape[-3], x.shape[-2]
    ar = torch.arange(hw, dtype=torch.float32, device=x.device)
    ys = ((ar + 0.5) * (h / hw) - 0.5).clamp(0.0, h - 1.0)
    xs = ((ar + 0.5) * (w / hw) - 0.5).clamp(0.0, w - 1.0)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return grid_sample_bilinear(x, gx, gy)


def _crop_or_pad(t, size: int, dim: int):
    """Centre crop, or zero pad split (pad // 2, pad - pad // 2), along dim."""
    cur = t.shape[dim]
    if cur >= size:
        return t.narrow(dim, (cur - size) // 2, size)
    pad = size - cur
    cfg = [0, 0] * (t.dim() - 1 - dim) + [pad // 2, pad - pad // 2]
    return F.pad(t, cfg)


class BevSegHead(nn.Module):
    """Dynamic + static segmentation logits on a square seg grid.

    The BEV feature covers ``cav_range`` at its own resolution; the seg map
    covers a centred square of ``seg_hw * seg_res`` metres. ``crop`` cuts
    (or zero-pads) the NCHW feature to that extent; ``forward`` then applies
    the 1x1 heads and resizes the logits to ``seg_hw``, returning NHWC.
    seg_branch: 'dynamic' | 'static' | 'both'.
    """

    def __init__(self, in_ch: int, seg_branch: str, seg_hw: int,
                 dynamic_class: int, static_class: int, seg_res: float,
                 cav_range):
        super().__init__()
        if seg_branch not in ("dynamic", "static", "both"):
            raise ValueError(f"unknown seg_branch {seg_branch!r}")
        self.seg_hw = int(seg_hw)
        self.extent_m = self.seg_hw * float(seg_res)
        self.range_x = float(cav_range[3]) - float(cav_range[0])
        self.range_y = float(cav_range[4]) - float(cav_range[1])
        self.dynamic_head = self.static_head = None
        if seg_branch in ("dynamic", "both"):
            # dynamic_class already counts the background class
            self.dynamic_head = nn.Conv2d(in_ch, dynamic_class, 1)
        if seg_branch in ("static", "both"):
            self.static_head = nn.Conv2d(in_ch, static_class, 1)

    def crop(self, x):
        """(B, C, H, W) covering cav_range -> (B, C, crop_h, crop_w) covering
        the seg extent (rows follow y, columns x)."""
        h, w = x.shape[-2:]
        crop_h = int(round(self.extent_m * (h / self.range_y)))
        crop_w = int(round(self.extent_m * (w / self.range_x)))
        return _crop_or_pad(_crop_or_pad(x, crop_h, 2), crop_w, 3)

    def forward(self, x):
        """(B, C, H, W) -> {"dynamic_seg": (B, seg_hw, seg_hw, dynamic_class),
        "static_seg": (B, seg_hw, seg_hw, static_class)} logits."""
        x = self.crop(x)
        out = {}
        for key, head in (("dynamic_seg", self.dynamic_head),
                          ("static_seg", self.static_head)):
            if head is not None:
                out[key] = _bilinear_resize(head(x).permute(0, 2, 3, 1),
                                            self.seg_hw)
        return out
