"""BEV convolutional backbone, eval mode (counterpart of
airv2x_tpu/models/bev_backbone.py).

N stages of [stride-s ConvBNReLU + layer_nums[i] ConvBNReLU], each followed
by a transposed-conv deblock back to a common resolution; the ups are
concatenated. ``stage`` / ``deblock`` / ``finish`` let the multi-scale
fusion rerun the same (shared) stages.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from airv2x_tpu_torch.models.nn import ConvBNReLU, DeconvBNReLU


class BEVStage(nn.Module):
    FLAX_NAMES = {"layers": "ConvBNReLU"}

    def __init__(self, in_ch: int, features: int, stride: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            [ConvBNReLU(in_ch, features, stride=stride)]
            + [ConvBNReLU(features, features) for _ in range(num_layers)]
        )

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class BaseBEVBackbone(nn.Module):
    def __init__(
        self,
        in_ch: int,
        layer_nums: Sequence[int],
        layer_strides: Sequence[int],
        num_filters: Sequence[int],
        upsample_strides: Sequence[int],
        num_upsample_filters: Sequence[int],
    ):
        super().__init__()
        if len(upsample_strides) > len(layer_nums):
            raise NotImplementedError("a final deblock is not ported")
        ins = [in_ch] + list(num_filters[:-1])
        self.stages = nn.ModuleList(
            BEVStage(i, f, s, n)
            for i, f, s, n in zip(ins, num_filters, layer_strides, layer_nums)
        )
        self.deblocks = nn.ModuleList(
            DeconvBNReLU(i, f, s)
            for i, f, s in zip(num_filters, num_upsample_filters,
                               upsample_strides)
        )
        self.out_channels = sum(num_upsample_filters)

    def stage(self, i: int, x):
        return self.stages[i](x)

    def deblock(self, i: int, x):
        return self.deblocks[i](x)

    def finish(self, ups):
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]

    def forward(self, x):
        """(B, C, H, W) -> (fused 2d map, {spatial_features_<s>x: stage out})."""
        ups, multiscale = [], {}
        h0 = x.shape[-2]
        for i in range(len(self.stages)):
            x = self.stage(i, x)
            multiscale[f"spatial_features_{h0 // x.shape[-2]}x"] = x
            ups.append(self.deblock(i, x))
        return self.finish(ups), multiscale
