"""Shared neural building blocks, eval mode (counterpart of
airv2x_tpu/models/nn.py).

Modules compute in NCHW; BatchNorm uses the reference's eps = 1e-3.
``FLAX_NAMES`` maps each child attribute to its flax scope name, which the
weight bridge (``utils/weights.py``) follows; a ``ModuleList`` child ``x``
maps to scopes ``<name>_0``, ``<name>_1``, ...
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

BN_EPS = 1e-3


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis of a point set (flax
    ``MaskedBatchNorm``; its mask only matters for training statistics)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        """(a, b) with bn(x) = a * x + b."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + self.eps)
        return (x - self.running_mean) * inv * self.weight + self.bias


class ConvBNReLU(nn.Module):
    """3x3 Conv (padding 1) -> BatchNorm -> ReLU block of the BEV backbone."""

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


class DeconvBNReLU(nn.Module):
    """Transposed-conv upsampling block (backbone deblocks), stride >= 1."""

    FLAX_NAMES = {"deconv": "ConvTranspose_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, features: int, stride: int):
        super().__init__()
        if stride < 1:
            raise NotImplementedError("downsampling deblocks are not ported")
        self.deconv = nn.ConvTranspose2d(in_ch, features, stride,
                                         stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.deconv(x)))


class DoubleConv(nn.Module):
    """Conv(k, s) -> ReLU -> Conv3x3 -> ReLU, biased, no norm (shrink block)."""

    FLAX_NAMES = {"conv0": "Conv_0", "conv1": "Conv_1"}

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 padding: int = 1):
        super().__init__()
        self.conv0 = nn.Conv2d(in_ch, features, kernel, stride=stride,
                               padding=padding)
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.conv1(torch.relu(self.conv0(x))))


class DownsampleConv(nn.Module):
    """Shrink head: stacked DoubleConv blocks."""

    FLAX_NAMES = {"blocks": "DoubleConv"}

    def __init__(self, in_ch: int, dims: Sequence[int], kernels: Sequence[int],
                 strides: Sequence[int], paddings: Sequence[int] | None = None):
        super().__init__()
        pads = paddings if paddings is not None else [1] * len(dims)
        blocks = []
        for d, k, s, p in zip(dims, kernels, strides, pads):
            blocks.append(DoubleConv(in_ch, d, kernel=k, stride=s, padding=p))
            in_ch = d
        self.blocks = nn.ModuleList(blocks)
        self.out_channels = in_ch

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x
