"""Early-fusion PointPillars (counterpart of
airv2x_tpu/models/early_fusion_model.py: ``point_pillar_early`` /
``airv2x_early`` and the DiscoNet teacher).

Every agent's ego-frame cloud is merged into one: the agent axis of the
padded point tensor flattens into the point axis, an absent agent's points
masked out, so K1 sees one cloud of L x N points per scene and the spine
runs on that single map.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase, _rate


class PointPillarEarly(PointPillarBase):
    """``point_pillar_early`` / ``airv2x_early``: the fused map is the merged
    cloud's map (comm_rate 0)."""

    def encode(self, batch):
        pts = batch["points"]  # (B, L, N, F)
        b, l, n, f = pts.shape
        merged = {
            "points": pts.reshape(b, 1, l * n, f),
            "points_mask": (batch["points_mask"]
                            & batch["agent_mask"][..., None].bool()
                            ).reshape(b, 1, l * n),
            "agent_mask": torch.ones((b, 1), dtype=torch.bool, device=pts.device),
        }
        return super().encode(merged)


class PointPillarDiscoNetTeacher(PointPillarEarly):
    """``point_pillar_disconet_teacher``: the early-fusion KD teacher. It
    returns the pre-head BEV map as ``teacher_feature`` (NHWC) with
    ``teacher_psm`` / ``teacher_rm``, and ``psm`` / ``rm`` aliases so the
    train and eval tools run on the teacher itself. It has no objectness
    head (the JAX teacher never calls one, so flax creates none)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.obj_head = None

    def forward(self, batch):
        fused = self.backbone_2d(self.encode(batch))[:, 0]
        out = self.heads(fused)
        return {
            "teacher_feature": fused.permute(0, 2, 3, 1),
            "teacher_psm": out["psm"],
            "teacher_rm": out["rm"],
            "psm": out["psm"],
            "rm": out["rm"],
            "comm_rate": _rate(0.0, fused),
        }
