"""Camera-trunk building blocks, eval and train mode (counterpart of
airv2x_tpu/models/camera/trunks.py).

  * ``EfficientNetB0Features``: the EfficientNet-b0 feature pyramid of the
    LSS ``CamEncode`` (stem + 16 MBConv blocks with squeeze-excitation,
    swish, TF-style static SAME padding), returning its reduction_3/4/5
    endpoints;
  * ``TorchBasicBlock``: the torchvision resnet BasicBlock of the BEV
    encoder;
  * ``TorchBottleneck`` and ``ResNet101Trunk``: the torchvision Bottleneck
    and resnet101 cut after layer2 (512 channels at /8), the trunk of
    ``camera_encoder: Resnet101``;
  * ``UpBlock``: align-corners bilinear upsample, pad (or crop) to the skip,
    concat [skip, x], then (conv3x3, BN, ReLU) twice;
  * ``upsample_align_corners`` / ``pad_or_crop_to``: the two resize helpers.

Modules compute in NCHW (``channels_last`` in memory where the caller makes
it so). Children carry the flax scope names, which the weight bridge
(``utils/weights.py``) follows. BatchNorm eps and momentum follow each
torch source: EfficientNet's eps 1e-3 and torch momentum 0.01 (flax 0.99),
the resnet and Up blocks' eps 1e-5 and torch momentum 0.1 (flax 0.9,
``torch_bn``). Drop-connect is a train-time regulariser and, as in the JAX
package, not applied.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.nn import BatchNorm2d

TORCH_BN_EPS = 1e-5
TORCH_BN_MOMENTUM = 0.9  # flax's running-average coefficient (torch 0.1)
EFF_BN_EPS = 1e-3
EFF_BN_MOMENTUM = 0.99  # torch 0.01

# EfficientNet-b0 block args (kernel, stride, expand, in_c, out_c, repeats)
EFFNET_B0_STAGES = (
    (3, 1, 1, 32, 16, 1),
    (3, 2, 6, 16, 24, 2),
    (5, 2, 6, 24, 40, 2),
    (3, 2, 6, 40, 80, 3),
    (5, 1, 6, 80, 112, 3),
    (5, 2, 6, 112, 192, 4),
    (3, 1, 6, 192, 320, 1),
)


def torch_bn(num_features: int) -> BatchNorm2d:
    """A BatchNorm of the torchvision parts: eps 1e-5, flax momentum 0.9."""
    return BatchNorm2d(num_features, eps=TORCH_BN_EPS, momentum=TORCH_BN_MOMENTUM)


def swish(x):
    return F.silu(x)


def static_same_padding(kernel: int, stride: int):
    """TF-style SAME padding of efficientnet_pytorch's
    Conv2dStaticSamePadding for even feature sizes: total pad k - s split
    (low pad // 2, high pad - pad // 2), asymmetric at stride 2."""
    pad = max(kernel - stride, 0)
    lo, hi = pad // 2, pad - pad // 2
    return ((lo, hi), (lo, hi))


class SameConv2d(nn.Conv2d):
    """A conv with ``static_same_padding``: an explicit ``F.pad`` where the
    split is asymmetric, the conv's own padding where it is symmetric (the
    same zeros, without the copy)."""

    def __init__(self, in_c, out_c, kernel, stride=1, groups=1, bias=False):
        (lo, hi), _ = static_same_padding(kernel, stride)
        super().__init__(in_c, out_c, kernel, stride=stride,
                         padding=lo if lo == hi else 0, groups=groups,
                         bias=bias)
        self.pad = None if lo == hi else (lo, hi, lo, hi)

    def forward(self, x):
        return super().forward(x if self.pad is None else F.pad(x, self.pad))


def upsample_align_corners(x, out_h: int, out_w: int):
    """Bilinear resize of NCHW ``x`` with torch's align_corners=True (the JAX
    package's ``upsample_align_corners``, which reproduces it)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def pad_or_crop_to(x, out_h: int, out_w: int):
    """``F.pad(x, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])`` to
    (out_h, out_w): a negative pad crops."""
    dy, dx = out_h - x.shape[-2], out_w - x.shape[-1]
    if dy == 0 and dx == 0:
        return x
    return F.pad(x, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])


class MBConvBlock(nn.Module):
    """efficientnet_pytorch MBConvBlock: expand -> depthwise -> SE ->
    project, with the identity skip at stride 1 when in_c == out_c. The SE
    reduction width comes from the block's *input* channels."""

    def __init__(self, in_c: int, out_c: int, kernel: int, stride: int,
                 expand: int, se_ratio: float = 0.25):
        super().__init__()
        mid = in_c * expand
        self.skip = stride == 1 and in_c == out_c
        if expand != 1:
            self.expand_conv = nn.Conv2d(in_c, mid, 1, bias=False)
            self.bn0 = BatchNorm2d(mid, eps=EFF_BN_EPS, momentum=EFF_BN_MOMENTUM)
        else:
            self.expand_conv = None
        self.depthwise_conv = SameConv2d(mid, mid, kernel, stride, groups=mid)
        self.bn1 = BatchNorm2d(mid, eps=EFF_BN_EPS, momentum=EFF_BN_MOMENTUM)
        se_c = max(1, int(in_c * se_ratio))
        self.se_reduce = nn.Conv2d(mid, se_c, 1)
        self.se_expand = nn.Conv2d(se_c, mid, 1)
        self.project_conv = nn.Conv2d(mid, out_c, 1, bias=False)
        self.bn2 = BatchNorm2d(out_c, eps=EFF_BN_EPS, momentum=EFF_BN_MOMENTUM)

    def forward(self, x):
        inputs = x
        if self.expand_conv is not None:
            x = swish(self.bn0(self.expand_conv(x)))
        x = swish(self.bn1(self.depthwise_conv(x)))
        s = x.mean((2, 3), keepdim=True)
        s = self.se_expand(swish(self.se_reduce(s)))
        x = x * torch.sigmoid(s)
        x = self.bn2(self.project_conv(x))
        return x + inputs if self.skip else x


class EfficientNetB0Features(nn.Module):
    """Stem + MBConv blocks ``block0`` .. ``block15``, returning the
    reduction_3/4/5 endpoints of ``CamEncode.get_eff_features``: features
    at /8 (40 ch), /16 (112 ch) and /32 (320 ch) of the input."""

    def __init__(self):
        super().__init__()
        self.conv_stem = SameConv2d(3, 32, 3, 2)
        self.bn0 = BatchNorm2d(32, eps=EFF_BN_EPS, momentum=EFF_BN_MOMENTUM)
        self.strides = []
        idx = 0
        for kernel, stride, expand, in_c, out_c, repeats in EFFNET_B0_STAGES:
            for r in range(repeats):
                s = stride if r == 0 else 1
                self.add_module(f"block{idx}", MBConvBlock(
                    in_c if r == 0 else out_c, out_c, kernel, s, expand))
                self.strides.append(s)
                idx += 1

    def forward(self, x):
        x = swish(self.bn0(self.conv_stem(x)))
        endpoints = []
        for i, s in enumerate(self.strides):
            if s > 1:  # the output before each downsampling block
                endpoints.append(x)
            x = self.get_submodule(f"block{i}")(x)
        endpoints.append(x)
        return endpoints[2], endpoints[3], endpoints[4]


class TorchBasicBlock(nn.Module):
    """torchvision resnet BasicBlock (eps 1e-5); ``downsample`` adds the
    1x1 strided projection of the identity."""

    def __init__(self, in_c: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn1 = torch_bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = torch_bn(planes)
        if downsample:
            self.ds_conv = nn.Conv2d(in_c, planes, 1, stride=stride,
                                     bias=False)
            self.ds_bn = torch_bn(planes)
        else:
            self.ds_conv = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.ds_conv is None else self.ds_bn(self.ds_conv(x))
        return torch.relu(y + identity)


class TorchBottleneck(nn.Module):
    """torchvision resnet Bottleneck (expansion 4, the stride on conv2, eps
    1e-5); ``downsample`` adds the 1x1 strided projection of the
    identity."""

    def __init__(self, in_c: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, planes, 1, bias=False)
        self.bn1 = torch_bn(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = torch_bn(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = torch_bn(planes * 4)
        if downsample:
            self.ds_conv = nn.Conv2d(in_c, planes * 4, 1, stride=stride,
                                     bias=False)
            self.ds_bn = torch_bn(planes * 4)
        else:
            self.ds_conv = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.ds_conv is None else self.ds_bn(self.ds_conv(x))
        return torch.relu(y + identity)


class ResNet101Trunk(nn.Module):
    """resnet101 cut after layer2, which is resnet50's (lss_submodule's
    CamEncode_Resnet101): conv1 7x7 / 2, BN, ReLU, 3x3 / 2 max pool, layer1
    (3 Bottlenecks of 64) and layer2 (4 of 128, the first at stride 2) ->
    512 channels at /8 of the input."""

    LAYERS = tuple(f"layer1_{i}" for i in range(3)) + tuple(
        f"layer2_{i}" for i in range(4))

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = torch_bn(64)
        for i in range(3):
            self.add_module(f"layer1_{i}", TorchBottleneck(
                64 if i == 0 else 256, 64, downsample=i == 0))
        for i in range(4):
            self.add_module(f"layer2_{i}", TorchBottleneck(
                256 if i == 0 else 512, 128, stride=2 if i == 0 else 1,
                downsample=i == 0))

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.LAYERS:
            x = self.get_submodule(name)(x)
        return x


class UpBlock(nn.Module):
    """lss_submodule.Up: upsample x by ``scale`` (align corners), pad or crop
    it to the skip's size, concat [skip, x], then (conv3x3, BN, ReLU) twice.
    ``in_c`` is the concatenation's width."""

    def __init__(self, in_c: int, out_c: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv0 = nn.Conv2d(in_c, out_c, 3, padding=1, bias=False)
        self.bn0 = torch_bn(out_c)
        self.conv1 = nn.Conv2d(out_c, out_c, 3, padding=1, bias=False)
        self.bn1 = torch_bn(out_c)

    def forward(self, x, skip):
        x = upsample_align_corners(x, x.shape[-2] * self.scale,
                                   x.shape[-1] * self.scale)
        x = pad_or_crop_to(x, skip.shape[-2], skip.shape[-1])
        x = torch.cat([skip, x], dim=1)
        x = torch.relu(self.bn0(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))
