"""spconv's semantics as masked dense 3-D convolutions (counterpart of
airv2x_tpu/models/sparse3d.py), for RTNH's radar backbone.

Features are NCDHW over the radar grid (depth z, height y, width x); each
layer carries a (B, Z, Y, X) bool mask of the active sites beside them:

  * ``SubMConv3d``: a centred SAME ``nn.Conv3d`` of the masked input, times
    the input mask (the active set is unchanged; spconv ignores a
    submanifold conv's padding);
  * ``SparseConv3d``: a strided ``nn.Conv3d`` of the masked input, times the
    dilated mask (``dilate_mask_3d``: an output site is active where any
    input site in its window is);
  * ``SparseBN``: the port's ``MaskedBatchNorm`` over the active sites,
    with RTNH's torch defaults (eps 1e-5, torch momentum 0.1: flax's 0.9);
  * ``TorchDeconv2d``: torch's ``ConvTranspose2d(k, s, p)``. The JAX package
    writes it as an input-dilated correlation with the flipped kernel (a
    flax ``Conv``); the weight bridge flips and transposes that kernel into
    the transposed conv's, as it does for every ``ConvTranspose2d``.

None of these is a Pallas kernel in the JAX package: cuDNN computes them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.nn import BatchNorm2d, MaskedBatchNorm

# RTNH builds torch BatchNorms with their defaults, unlike the OpenCOOD PFN /
# backbone norms (eps 1e-3, torch momentum 0.01)
TORCH_BN_EPS = 1e-5
TORCH_BN_MOMENTUM = 0.9  # flax's momentum: 1 - torch's 0.1


def _triple(v) -> tuple:
    return tuple(int(a) for a in v) if isinstance(v, Sequence) else (int(v),) * 3


def dilate_mask_3d(mask, kernel, stride, padding):
    """The active sites of a strided sparse conv's output: (B, Z, Y, X) bool
    -> bool, a max-pool of the mask over the conv's windows."""
    k, s, p = _triple(kernel), _triple(stride), _triple(padding)
    out = F.max_pool3d(mask[:, None].float(), k, s, p)
    return out[:, 0] > 0.5


class SparseConv3d(nn.Module):
    """spconv ``SparseConv3d``: conv of the masked input times the dilated
    mask; ``forward(x, mask) -> (y, mask_out)``."""

    FLAX_NAMES = {"conv": "Conv_0"}

    def __init__(self, in_ch: int, features: int, kernel=(3, 3, 3), stride=1,
                 padding=0, bias: bool = True):
        super().__init__()
        self.kernel, self.stride, self.padding = (
            _triple(kernel), _triple(stride), _triple(padding))
        self.conv = nn.Conv3d(in_ch, features, self.kernel, stride=self.stride,
                              padding=self.padding, bias=bias)

    def forward(self, x, mask):
        y = self.conv(x * mask[:, None].to(x.dtype))
        out = dilate_mask_3d(mask, self.kernel, self.stride, self.padding)
        return y * out[:, None].to(y.dtype), out


class SubMConv3d(nn.Module):
    """spconv ``SubMConv3d``: centred SAME conv times the input mask."""

    FLAX_NAMES = {"conv": "Conv_0"}

    def __init__(self, in_ch: int, features: int, kernel=(3, 3, 3),
                 bias: bool = True):
        super().__init__()
        k = _triple(kernel)
        self.conv = nn.Conv3d(in_ch, features, k,
                              padding=tuple((a - 1) // 2 for a in k), bias=bias)

    def forward(self, x, mask):
        m = mask[:, None].to(x.dtype)
        return self.conv(x * m) * m, mask


class SparseBN(nn.Module):
    """BatchNorm1d over the active sites' feature rows, zero elsewhere."""

    FLAX_NAMES = {"bn": "MaskedBatchNorm_0"}

    def __init__(self, num_features: int):
        super().__init__()
        self.bn = MaskedBatchNorm(num_features, eps=TORCH_BN_EPS,
                                  momentum=TORCH_BN_MOMENTUM)

    def forward(self, x, mask):
        y = self.bn(x.permute(0, 2, 3, 4, 1), mask).permute(0, 4, 1, 2, 3)
        return y * mask[:, None].to(y.dtype)


class TorchDeconv2d(nn.Module):
    """torch ``ConvTranspose2d(k, s, p)``: out = (in - 1) s + k - 2 p."""

    FLAX_NAMES = {"deconv": "Conv_0"}

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int,
                 padding: int = 0, bias: bool = True):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_ch, features, kernel, stride=stride,
                                         padding=padding, bias=bias)

    def forward(self, x):
        return self.deconv(x)


class RadarSparseBackbone(nn.Module):
    """RTNH's backbone: a 1x1x1 input conv; per level a strided sparse conv
    and two submanifold convs, each with its BN and ReLU; the level's z
    collapsed by a (z_k, 1, 1) sparse conv + BN + ReLU, a transposed conv +
    BN + ReLU to the common BEV size, and the agent fusion ``fuse`` ((B * L,
    C, H, W) -> (B, C, H, W)); the fused levels concatenated on channels.
    Layer names are the flax scopes (``spconv{i}``, ``bn{i}a``, ...)."""

    def __init__(self, in_ch: int, enc_channels, enc_strides, enc_paddings,
                 bev_channels, bev_kernels, bev_strides, bev_paddings,
                 z_shape: int):
        super().__init__()
        self.levels = len(enc_channels)
        self.input_conv = SparseConv3d(in_ch, int(enc_channels[0]), kernel=1)
        prev = int(enc_channels[0])
        for i, ch in enumerate(int(c) for c in enc_channels):
            st, pd = int(enc_strides[i]), int(enc_paddings[i])
            self.add_module(f"spconv{i}", SparseConv3d(prev, ch, stride=st,
                                                       padding=pd))
            self.add_module(f"subm{i}a", SubMConv3d(ch, ch))
            self.add_module(f"subm{i}b", SubMConv3d(ch, ch))
            for suffix in ("", "a", "b"):
                self.add_module(f"bn{i}{suffix}", SparseBN(ch))
            zk = math.ceil(z_shape / (2 ** (i + 1)))
            self.add_module(f"toBEV{i}", SparseConv3d(ch, ch, kernel=(zk, 1, 1)))
            self.add_module(f"bnBEV{i}", SparseBN(ch))
            self.add_module(f"convtrans2d{i}", TorchDeconv2d(
                ch, int(bev_channels[i]), int(bev_kernels[i]),
                int(bev_strides[i]), int(bev_paddings[i])))
            self.add_module(f"bnt{i}", BatchNorm2d(
                int(bev_channels[i]), eps=TORCH_BN_EPS,
                momentum=TORCH_BN_MOMENTUM))
            prev = ch
        self.out_channels = sum(int(c) for c in bev_channels[:self.levels])

    def forward(self, x, mask, fuse):
        """x (B * L, C, Z, Y, X) zero off ``mask`` (B * L, Z, Y, X)."""
        x, mask = self.input_conv(x, mask)
        outs = []
        for i in range(self.levels):
            layer = self.get_submodule
            for conv, bn in ((f"spconv{i}", f"bn{i}"), (f"subm{i}a", f"bn{i}a"),
                             (f"subm{i}b", f"bn{i}b")):
                x, mask = layer(conv)(x, mask)
                x = torch.relu(layer(bn)(x, mask))
            bev, bev_mask = layer(f"toBEV{i}")(x, mask)
            bev = torch.relu(layer(f"bnBEV{i}")(bev, bev_mask))[:, :, 0]
            bev = torch.relu(layer(f"bnt{i}")(layer(f"convtrans2d{i}")(bev)))
            outs.append(fuse(bev))
        return torch.cat(outs, dim=1)
