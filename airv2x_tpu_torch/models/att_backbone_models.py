"""The attention-backbone, PFA-Net and SpatialCooper models of V2X-R, in
eval and train mode (counterpart of airv2x_tpu/models/att_backbone_models.py).

  * point_pillar_attresnet (``PointPillarAttResNet``): always the ResNet
    backbone; per level the non-ego maps warped into the ego frame (the
    normalized affine at the pillar grid, shared by every level) and fused
    by per-pixel self-attention over the present slots (``atten_fusion``),
    then the deblocks: CoAlign's spine (``coalign_model.py``) on the
    ``base_bev_backbone`` config;
  * PFA_net / pfanet / pfa_net (``PFAnet``): the per-stage AttFusion model
    on the cloud ``use_modality`` selects;
  * point_pillar_spatialcooper / point_pillar_adafusion
    (``PointPillarSpatialCooper``): the masked max and mean over the
    agents stacked as the two channels of a 3-D volume whose spatial axes
    are (feature channel, H, W), blended by a Conv3d(2 -> 1, k 3, pad 1) and
    ReLU.

``use_modality: processed_radar`` among the model args makes PFA-Net and
SpatialCooper encode ``radar_points`` in place of ``points``; only those
two classes read the key, and only from the model args (ROADMAP §3).
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.coalign_model import PointPillarCoAlign
from airv2x_tpu_torch.models.fusion.common import max_fusion, mean_fusion
from airv2x_tpu_torch.models.point_pillar_models import (
    PointPillarBase, PointPillarIntermediate, _rate)


class _ModalitySelect:
    """``use_modality: processed_radar`` among the model args: ``encode``
    reads the radar cloud in place of ``points``."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.reads_radar = (str(args.get("use_modality", ""))
                            == "processed_radar")

    def encode(self, batch):
        if self.reads_radar:
            batch = dict(batch, points=batch["radar_points"],
                         points_mask=batch["radar_points_mask"])
        return super().encode(batch)


class PointPillarAttResNet(PointPillarCoAlign):
    """ResNet levels, each fused in the ego frame by ``atten_fusion``."""

    _force_resnet_backbone = True


class PFAnet(_ModalitySelect, PointPillarIntermediate):
    """Per-stage AttFusion on the cloud ``use_modality`` selects."""


class PointPillarSpatialCooper(_ModalitySelect, PointPillarBase):
    """S-AdaFusion: the max and mean fusions blended by a Conv3d over
    (feature channel, H, W)."""

    def __init__(self, args: dict):
        super().__init__(args)
        self.spatial_fuse3d = nn.Conv3d(2, 1, 3, padding=1)

    def fuse(self, grouped, batch):
        am = batch["agent_mask"]
        vol = torch.stack([max_fusion(grouped, am), mean_fusion(grouped, am)],
                          dim=1)  # (B, 2, C, H, W)
        out = torch.relu(self.spatial_fuse3d(
            vol.to(self.spatial_fuse3d.weight.dtype)))
        return out[:, 0], _rate(1.0, grouped)
