"""ResNet-style BEV backbone (counterpart of airv2x_tpu/models/resnet_bev.py:
``BasicBlock``, the ResNeXt ``BottleneckX``, ``ResNetStage`` and
``ResNetBEVBackbone``).

N stages of BasicBlocks, or with ``resnext`` of grouped bottlenecks (the
first block strided, with a 1x1 strided projection of the identity where
the shape changes), each followed by a transposed-conv deblock back to a
common resolution; the ups are concatenated. Without deblocks
(``upsample_strides: []``, HEAL's and STAMP's modality backbones) the
decoded map is the last stage's output. ``get_multiscale_feature`` /
``decode_multiscale`` split the pass for per-level fusion. BatchNorm is
the reference's eps 1e-3.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from airv2x_tpu_torch.models.nn import BatchNorm2d, DeconvBNReLU


class BasicBlock(nn.Module):
    """3x3 conv (stride s, explicit padding 1) -> BN -> ReLU -> 3x3 conv ->
    BN, plus the identity (projected by a bias-free 1x1 stride-s conv + BN
    when ``downsample``), then ReLU."""

    FLAX_NAMES = {"conv0": "Conv_0", "bn0": "BatchNorm_0", "conv1": "Conv_1",
                  "bn1": "BatchNorm_1", "down_conv": "Conv_2",
                  "down_bn": "BatchNorm_2"}

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn0 = BatchNorm2d(planes)
        self.conv1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.down_conv = self.down_bn = None
        if downsample:
            self.down_conv = nn.Conv2d(in_ch, planes, 1, stride=stride,
                                       bias=False)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        identity = x if self.down_conv is None else self.down_bn(
            self.down_conv(x))
        return torch.relu(y + identity)


class BottleneckX(nn.Module):
    """ResNeXt bottleneck with expansion 1: 1x1 conv to ``width`` -> BN ->
    ReLU -> grouped 3x3 conv (stride s, explicit padding 1) -> BN -> ReLU ->
    1x1 conv back to ``planes`` -> BN, plus the identity (projected as in
    ``BasicBlock``), then ReLU. ``width = int(planes * width_per_group /
    64) * groups`` (HEAL: 32 groups of 4)."""

    FLAX_NAMES = {"conv0": "Conv_0", "bn0": "BatchNorm_0", "conv1": "Conv_1",
                  "bn1": "BatchNorm_1", "conv2": "Conv_2", "bn2": "BatchNorm_2",
                  "down_conv": "Conv_3", "down_bn": "BatchNorm_3"}

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 32,
                 width_per_group: int = 4):
        super().__init__()
        width = int(planes * (width_per_group / 64.0)) * groups
        self.conv0 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn0 = BatchNorm2d(width)
        self.conv1 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               groups=groups, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, planes, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.down_conv = self.down_bn = None
        if downsample:
            self.down_conv = nn.Conv2d(in_ch, planes, 1, stride=stride,
                                       bias=False)
            self.down_bn = BatchNorm2d(planes)

    def forward(self, x):
        y = torch.relu(self.bn0(self.conv0(x)))
        y = torch.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        identity = x if self.down_conv is None else self.down_bn(
            self.down_conv(x))
        return torch.relu(y + identity)


class ResNetStage(nn.Module):
    """``blocks`` blocks, the first strided. ``in_planes`` decides whether
    the first projects its identity (as the config's width does in the JAX
    package); ``in_ch``, by default ``in_planes``, is the width it
    receives."""

    def __init__(self, in_planes: int, planes: int, blocks: int, stride: int,
                 resnext: bool = False, in_ch: int | None = None):
        super().__init__()
        block = BottleneckX if resnext else BasicBlock
        self.FLAX_NAMES = {"blocks": block.__name__}
        need_ds = stride != 1 or in_planes != planes
        self.blocks = nn.ModuleList(
            [block(in_planes if in_ch is None else in_ch, planes, stride,
                   downsample=need_ds)]
            + [block(planes, planes) for _ in range(1, blocks)])

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ResNetBEVBackbone(nn.Module):
    def __init__(
        self,
        layer_nums: Sequence[int],
        layer_strides: Sequence[int],
        num_filters: Sequence[int],
        upsample_strides: Sequence[int],
        num_upsample_filters: Sequence[int],
        inplanes: int = 64,
        resnext: bool = False,
        in_ch: int | None = None,
    ):
        """``inplanes`` is the config's input width, ``in_ch`` (by default
        ``inplanes``) the width of the maps the backbone receives."""
        super().__init__()
        if len(upsample_strides) not in (0, len(layer_nums)):
            raise NotImplementedError(
                "only one deblock per stage, or none, is ported")
        ins = [inplanes] + list(num_filters[:-1])
        self.stages = nn.ModuleList(
            ResNetStage(i, f, n, s, resnext, in_ch if k == 0 else None)
            for k, (i, f, n, s) in enumerate(
                zip(ins, num_filters, layer_nums, layer_strides)))
        self.deblocks = nn.ModuleList(
            DeconvBNReLU(i, f, s)
            for i, f, s in zip(num_filters, num_upsample_filters,
                               upsample_strides))
        self.out_channels = (sum(num_upsample_filters) if upsample_strides
                             else num_filters[-1])

    def get_multiscale_feature(self, x):
        """(B, C, H, W) -> every stage's output."""
        feats = []
        for stage in self.stages:
            x = stage(x)
            feats.append(x)
        return feats

    def decode_multiscale(self, feats):
        """Each level through its deblock (its input cast to the deblock's
        weight dtype: a fused level is f32 after the warp), concatenated on
        channels; without deblocks the last level as it is."""
        if not len(self.deblocks):
            return feats[-1]
        ups = [self.deblocks[i](f.to(self.deblocks[i].deconv.weight.dtype))
               for i, f in enumerate(feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]

    def forward(self, x):
        """(B, C, H, W) -> (fused 2d map, per-stage features)."""
        feats = self.get_multiscale_feature(x)
        return self.decode_multiscale(feats), feats
