"""Shared neural building blocks (counterpart of airv2x_tpu/models/nn.py).

Modules compute in NCHW; BatchNorm uses the reference's eps = 1e-3 and, in
train mode, flax's statistics: f32 batch statistics, the biased batch
variance in the running average, flax momentum 0.99 (torch's 0.01) unless
a module gives its own (the camera trunks' torchvision parts and SCOPE's
temporal BNs take 0.9, torch's 0.1, as in the JAX package).
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
BN_MOMENTUM = 0.99  # flax: ema = m * ema + (1 - m) * batch


def _ema_(running: torch.Tensor, batch: torch.Tensor,
          momentum: float = BN_MOMENTUM) -> None:
    """Flax's running-average update with flax ``momentum``, in place (bumps
    the tensor's version, which ``ConvBNReLU._fold`` keys its cache on)."""
    running.copy_(momentum * running + (1 - momentum) * batch)


CONV_KERNEL_MODES = ("auto", "xla", "pallas", "im2col")


def _conv3x3_mode(shape, dtype, features: int) -> str:
    """Eval backend of a 3x3 stride-1 ``ConvBNReLU`` on NHWC ``shape``.

    ``AIRV2X_CONV_KERNEL``, read at every forward as the JAX package reads
    it at trace time: ``auto`` (the default) and ``xla`` give ``"cudnn"``
    (Conv2d -> BatchNorm2d -> ReLU, as ``auto`` means XLA there);
    ``pallas`` gives ``"kernel"``, K4 with the BN folded in, and raises
    where the support gate refuses the shape; ``im2col`` the unfold +
    matmul form. Any other value raises (the JAX package reads it as
    ``auto``), so a mistyped mode cannot time cuDNN unnoticed.
    """
    mode = os.environ.get("AIRV2X_CONV_KERNEL", "auto")
    if mode not in CONV_KERNEL_MODES:
        raise ValueError(f"AIRV2X_CONV_KERNEL={mode!r}: expected one of "
                         f"{', '.join(CONV_KERNEL_MODES)}")
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
    """BatchNorm over the last axis of a padded point set (flax
    ``MaskedBatchNorm``, flax ``momentum``). In train mode the statistics are taken over the
    rows where ``mask`` is True only, in f32: the masked mean, then the
    masked mean of squared deviations (two passes, as the JAX package).
    Each sum accumulates in f64 and rounds once to f32, so the statistics
    do not depend on the order of the sums (the CPU's, the card's, XLA's):
    downstream of them a train step's gradients can amplify a one-ulp
    difference in a statistic a thousandfold."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__()
        self.eps = eps
        self.flax_momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def affine(self):
        """(a, b) with bn(x) = a * x + b."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return a, self.bias - self.running_mean * a

    def forward(self, x, mask=None):
        """x (..., C); mask (...) bool, needed in train mode only."""
        if self.training:
            m = mask[..., None].to(torch.float32)
            dims = tuple(range(x.dim() - 1))
            cnt = m.sum().clamp_min(1.0)
            xf = x.float()
            mean = ((xf * m).sum(dims, dtype=torch.float64) / cnt).float()
            var = (((xf - mean) ** 2 * m).sum(dims, dtype=torch.float64)
                   / cnt).float()
            with torch.no_grad():
                _ema_(self.running_mean, mean, self.flax_momentum)
                _ema_(self.running_var, var, self.flax_momentum)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode ``BatchNorm`` (a subclass, so
    the weight bridge's ``isinstance`` still matches). Train mode takes the
    batch statistics in f32 as flax does: the mean and the biased variance
    E[x^2] - E[x]^2 clamped at 0 (flax's ``use_fast_variance``, which rounds
    apart from torch's own variance by up to ~1e-4 relative where the mean
    dwarfs the spread), normalises with them in that type with the gradient
    flowing through both, casts to x's dtype, and updates the running
    averages with the flax ``momentum`` (torch's is 1 - momentum). Eval mode
    is the parent's."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=1 - momentum)
        self.flax_momentum = momentum

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean((0, 2, 3))
        var = ((xf * xf).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            _ema_(self.running_mean, mean, self.flax_momentum)
            _ema_(self.running_var, var, self.flax_momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(x.dtype)


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
        self.bn = BatchNorm2d(features)
        self._fold_key, self._fold_val = None, None

    def _fold(self, dtype):
        """(HWIO weight in ``dtype``, f32 scale, f32 bias, packed) of the conv
        and the eval BN, as models/nn.py of the JAX package folds them;
        ``packed`` is the f32 kernel's repacked tf32 split of the weight
        (``pack_f32_weights``; None in bf16). Cached until one of the five
        tensors changes (data pointer and version) or ``train()`` /
        ``eval()`` is called."""
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

    def train(self, mode: bool = True):
        # a fused optimizer step (torch.optim.AdamW(fused=True)) writes the
        # weights without bumping their version, so the fold cache cannot
        # see it: drop the cache whenever the mode is set (model.train(),
        # model.eval())
        self._fold_key, self._fold_val = None, None
        return super().train(mode)

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
        self.bn = BatchNorm2d(features)

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
