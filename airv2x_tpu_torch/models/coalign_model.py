"""CoAlign, in eval and train mode (counterpart of
airv2x_tpu/models/coalign_model.py: ``PointPillarCoAlign``).

Pillar encode (one K1 launch over the B * L clouds) -> the ResNet
backbone's stages (``res_bev_backbone``) -> per level, the non-ego slot
maps warped into the ego frame by the ego row of ``pairwise_t_full``
(normalized affine at the pillar grid, downsample rate 1) and fused by
per-pixel self-attention over the present slots (``atten_fusion``) -> the
levels' deblocks, concatenated -> the heads (comm_rate 1).

The pose-graph refinement of noisy poses (``utils/pose_graph.py``) runs on
the host before the forward; the IoU-aware loss is
``loss/point_pillar_binary.py:make_coalign_loss``.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.models.fusion.scope import atten_fusion
from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase, _rate
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


class PointPillarCoAlign(PointPillarBase):
    def __init__(self, args: dict):
        super().__init__(args)
        vs = args.get("voxel_size") or args["preprocess"]["args"]["voxel_size"]
        self.discrete_ratio = float(vs[0])

    def forward(self, batch):
        spatial = self.encode(batch)  # (B, L, H0, W0, C)
        b, l, h0, w0, c = spatial.shape
        agent_mask = batch["agent_mask"]
        aff = normalized_pairwise_affine(
            batch["pairwise_t_full"], h0, w0, self.discrete_ratio, 1.0)[:, 0]
        mask5 = agent_mask[:, :, None, None, None]
        x = spatial.reshape(b * l, h0, w0, c).permute(0, 3, 1, 2)
        fused = []
        for stage in self.backbone.stages:
            x = stage(x.to(self.compute_dtype))
            xi = x.unflatten(0, (b, l)).permute(0, 1, 3, 4, 2)
            xi = torch.cat([xi[:, :1], warp_affine_normalized(xi[:, 1:], aff[:, 1:])],
                           dim=1)
            xi = xi * mask5.to(xi.dtype)
            fused.append(atten_fusion(xi, agent_mask).permute(0, 3, 1, 2))
        ups = [deblock(f.to(deblock.deconv.weight.dtype))
               for deblock, f in zip(self.backbone.deblocks, fused)]
        x_fuse = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        if self.shrink_conv is not None:
            x_fuse = self.shrink_conv(x_fuse)
        out = self.heads(x_fuse)
        out["comm_rate"] = _rate(1.0, x_fuse)
        return out
