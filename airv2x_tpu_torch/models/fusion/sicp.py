"""SiCP gated pairwise fusion (counterpart of airv2x_tpu/models/fusion/sicp.py).

The receiver (the ego, slot 0) and one sender's map warped into the ego
frame give a learned weight map, normalised to [0, 1] per sample; where the
sender's warped footprint overlaps, the two maps are blended by it, outside
it the receiver passes through. Every sender is fused with the ego in turn
by the same modules and the fused maps are averaged over the present
senders; a lone ego keeps its own map.

Per agent NCHW, the warps channels-last. The warp samples on an f32 grid,
so under a bf16 compute dtype the warped map, the overlap and the blend are
f32 and each conv casts its input to its weight's dtype, as in the JAX
package.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.nn import BatchNorm2d
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


class ConvBN(nn.Module):
    """Conv (SAME, biased) -> BatchNorm -> ReLU or sigmoid (flax
    ``_ConvBN``)."""

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, features: int, kernel: int,
                 act: str = "relu"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, kernel, padding=kernel // 2)
        self.bn = BatchNorm2d(features)
        self.act = torch.relu if act == "relu" else torch.sigmoid

    def forward(self, x):
        return self.act(self.bn(self.conv(x.to(self.conv.weight.dtype))))


class SpatialFusion(nn.Module):
    """Receiver / sender gated fusion; ``in_channels`` is the concatenated
    pair's width (twice an agent's), ``out_channels`` the fused map's."""

    FLAX_NAMES = {"comp1": "_ConvBN_0", "conv1": "_ConvBN_1",
                  "conv2": "_ConvBN_2", "comp2": "_ConvBN_3"}

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.out_channels = int(out_channels)
        self.comp1 = ConvBN(in_channels, 1, 1)
        self.conv1 = ConvBN(1, 1, 3)
        self.conv2 = ConvBN(1, 1, 3, act="sigmoid")
        self.comp2 = ConvBN(in_channels, out_channels, 1)

    def forward(self, x, agent_mask, pairwise_t_full, *, discrete_ratio,
                downsample_rate):
        """x (B, L, C, H, W), agent_mask (B, L), pairwise_t_full
        (B, L, L, 4, 4) -> (B, out_channels, H, W). Every sender slot runs
        (an absent one with its map zeroed and no weight in the mean), so in
        train mode each module's BN statistics update once per sender, as
        in the JAX package."""
        b, l, c, h, w = x.shape
        rec = x[:, 0]
        # the reference's lone-ego branch returns the raw ego map, which
        # only type-checks with in == out channels (every shipped config);
        # otherwise the pair module sees the ego beside zeros
        ego_only = rec if c == self.out_channels else self.comp2(
            torch.cat([rec, torch.zeros_like(rec)], dim=1))
        fused_sum = x.new_zeros((b, self.out_channels, h, w))
        count = x.new_zeros((b, 1, 1, 1))
        for j in range(1, l):
            valid = agent_mask[:, j].to(x.dtype)[:, None, None, None]
            sed = (x[:, j] * valid).permute(0, 2, 3, 1)
            aff = normalized_pairwise_affine(pairwise_t_full[:, 0, j], h, w,
                                             discrete_ratio, downsample_rate)
            t_sed = warp_affine_normalized(sed, aff).permute(0, 3, 1, 2)
            ones = x.new_ones((b, h, w, 1)) * valid
            overlap = warp_affine_normalized(ones, aff).mean(
                dim=-1, keepdim=True).permute(0, 3, 1, 2)
            non_overlap = torch.where(overlap > 0, 0.0, 1.0)
            comp = self.comp1(torch.cat([rec, t_sed], dim=1))
            wmap = comp + self.conv2(self.conv1(comp))
            wmin = wmap.amin(dim=(1, 2, 3), keepdim=True)
            wmax = wmap.amax(dim=(1, 2, 3), keepdim=True)
            wnorm = (wmap - wmin) / (wmax - wmin).clamp_min(1e-9)
            w_rec = rec * (wnorm * overlap + non_overlap)
            w_sed = t_sed * (1.0 - wnorm)
            fused = self.comp2(torch.cat([w_rec, w_sed], dim=1))
            fused_sum = fused_sum + fused * valid
            count = count + valid
        mean_fused = fused_sum / count.clamp_min(1.0)
        return torch.where(count > 0, mean_fused, ego_only)
