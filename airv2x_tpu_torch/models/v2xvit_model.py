"""Airv2x V2X-ViT model (counterpart of airv2x_tpu/models/v2xvit_model.py),
for the det and seg tasks, in eval and train mode.

The intermediate-fusion spine (``PostBackboneFusionModel``: hetero encode ->
shared BEV backbone, one pass -> shrink -> heads) with the V2X-ViT
transformer as its fusion: RTE, STTF warp by ``pairwise_t``, HGT agent
attention and the window-attention pyramid on the agents' maps, returning
the ego map.
"""

from __future__ import annotations

from airv2x_tpu_torch.models.fusion.v2xvit import V2XTransformer
from airv2x_tpu_torch.models.intermediate_models import PostBackboneFusionModel


class Airv2xV2XViT(PostBackboneFusionModel):
    def make_fusion(self, args, channels):
        return V2XTransformer(args["transformer"])

    def fuse(self, feats, batch):
        """Stage 3: the V2X-ViT transformer -> the fused ego map (B, C, H, W)
        (f32 under a bf16 compute dtype, as in JAX)."""
        return self.fusion_net(feats, batch["agent_mask"], batch["pairwise_t"],
                               batch["prior_encoding"])
