"""Shared neural building blocks, eval mode (counterpart of
airv2x_tpu/models/nn.py).

Modules compute in NCHW; BatchNorm uses the reference's eps = 1e-3.
``FLAX_NAMES`` maps each child attribute to its flax scope name, which the
weight bridge (``utils/weights.py``) follows; a ``ModuleList`` child ``x``
maps to scopes ``<name>_0``, ``<name>_1``, ...
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
from torch import nn

from airv2x_tpu_torch.ops.conv3x3 import (
    conv3x3_im2col,
    conv3x3_same,
    pack_f32_weights,
    supports_conv3x3,
)

BN_EPS = 1e-3


def _conv3x3_mode(shape, dtype, features: int) -> str:
    """Eval backend of a 3x3 stride-1 ``ConvBNReLU`` on NHWC ``shape``.

    ``AIRV2X_CONV_KERNEL``, read at every forward as the JAX package reads
    it at trace time: ``auto`` (the default) and ``xla`` give ``"cudnn"``
    (Conv2d -> BatchNorm2d -> ReLU, as ``auto`` means XLA there);
    ``pallas`` gives ``"kernel"``, K4 with the BN folded in, and raises
    where the support gate refuses the shape; ``im2col`` the unfold +
    matmul form.
    """
    mode = os.environ.get("AIRV2X_CONV_KERNEL", "auto")
    if mode == "im2col":
        return "im2col"
    if mode == "pallas":
        if not supports_conv3x3(shape, dtype, features):
            raise ValueError(
                f"AIRV2X_CONV_KERNEL=pallas but {tuple(shape)} -> {features} "
                "exceeds the kernel's support gate")
        return "kernel"
    return "cudnn"


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
    """3x3 Conv (padding 1) -> BatchNorm -> ReLU block of the BEV backbone.

    In eval mode at stride 1, ``AIRV2X_CONV_KERNEL`` picks the backend
    (``_conv3x3_mode``). The fused branches run on the NHWC view of x: for
    a ``channels_last`` input, as the backbone's activations are, that view
    is contiguous and no layout pass is made; the result is
    ``channels_last`` again.
    """

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, features, 3, stride=stride, padding=1,
                              bias=False)
        self.bn = nn.BatchNorm2d(features, eps=BN_EPS)
        self._fold_key, self._fold_val = None, None

    def _fold(self, dtype):
        """(HWIO weight in ``dtype``, f32 scale, f32 bias, packed) of the conv
        and the eval BN, as models/nn.py of the JAX package folds them;
        ``packed`` is the f32 kernel's repacked tf32 split of the weight
        (``pack_f32_weights``; None in bf16). Cached until one of the five
        tensors changes (data pointer and version)."""
        ts = (self.conv.weight, self.bn.weight, self.bn.bias,
              self.bn.running_mean, self.bn.running_var)
        key = None if any(t.is_inference() for t in ts) else (dtype,) + tuple(
            (t.data_ptr(), t._version) for t in ts)
        if key is None or key != self._fold_key:
            bn = self.bn
            scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                    + bn.eps)
            bias = bn.bias.float() - bn.running_mean.float() * scale
            w = self.conv.weight.permute(2, 3, 1, 0).to(dtype).contiguous()
            packed = pack_f32_weights(w) if dtype == torch.float32 else None
            self._fold_key, self._fold_val = key, (w, scale, bias, packed)
        return self._fold_val

    def forward(self, x):
        if not self.training and self.conv.stride == (1, 1):
            b, c, h, w = x.shape
            mode = _conv3x3_mode((b, h, w, c), x.dtype, self.conv.out_channels)
            if mode != "cudnn":
                w, scale, bias, packed = self._fold(x.dtype)
                xh = x.permute(0, 2, 3, 1)
                if mode == "kernel":
                    out = conv3x3_same(xh, w, scale, bias, relu=True,
                                       packed=packed)
                else:
                    out = conv3x3_im2col(xh, w, scale, bias, relu=True)
                return out.permute(0, 3, 1, 2)
        # cuDNN reads the module's own tensors: a fold cached by an earlier
        # forward (in f32 three copies of the weight) would only hold memory
        self._fold_key, self._fold_val = None, None
        return torch.relu(self.bn(self.conv(x)))


class PallasConv3x3(nn.Conv2d):
    """Bias-free 3x3 SAME conv through K4 (the flax ``PallasConv3x3``). It is
    a ``Conv2d``, so the weight bridge loads its HWIO kernel unchanged."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(in_ch, features, 3, padding=1, bias=False)

    def forward(self, x):
        w = self.weight.permute(2, 3, 1, 0).to(x.dtype)
        return conv3x3_same(x.permute(0, 2, 3, 1), w).permute(0, 3, 1, 2)


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
