"""Feature alignment nets, the deformable conv and the autoencoder compressor
(counterpart of airv2x_tpu/models/alignnet.py).

  * ``AlignNet``: the dispatcher over identity / scaligner / resnet1x1 /
    resnet3x3 (``deform``: both convs deformable) / cbam / convnext / sdta,
    which HEAL applies to its backbone's maps under an ``alignnet`` key;
  * ``DeformConv2d``: an offset conv predicts per pixel a (dy, dx) per
    tap; the input is sampled bilinearly at the displaced taps
    (``ops/warp.py:grid_sample_bilinear``, zero outside the map, in f32),
    then contracted with the (k, k, C, F) ``kernel`` once. The offset conv
    starts at zero (a plain conv at initialisation), as mmcv's does;
  * ``DCNNet``: stacked deformable convs;
  * ``AutoEncoder``: strided conv + BN + ReLU halving the channels per
    level, mirrored by 2x2 transposed convs (the per-stage compression,
    which no ported model wires yet: ROADMAP §1 item 9).

Maps are NCHW; the Linears and LayerNorms act channels-last, each Linear in
its weight's dtype and each LayerNorm with flax's f32 statistics. BatchNorm
is the backbone's (eps 1e-3, flax momentum 0.99). Layer names follow the
flax scopes (``FLAX_NAMES``; a ``ModuleList`` ``x`` maps to ``x_0``, ...).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.adapter import ConvNeXtBlock
from airv2x_tpu_torch.models.fusion.v2xvit import LayerNorm, _dense
from airv2x_tpu_torch.models.nn import BatchNorm2d
from airv2x_tpu_torch.ops.warp import grid_sample_bilinear


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu


def _cl(x):
    return x.permute(0, 2, 3, 1)


def _cf(x):
    return x.permute(0, 3, 1, 2)


def _conv(conv: nn.Conv2d, x):
    return conv(x.to(conv.weight.dtype))


class ResMLP(nn.Module):
    """LayerNorm, then ``num_layers`` x (Linear + GELU), plus the input."""

    FLAX_NAMES = {"norm": "LayerNorm_0", "fcs": "Dense"}

    def __init__(self, c: int, num_layers: int = 2):
        super().__init__()
        self.norm = LayerNorm(c)
        self.fcs = nn.ModuleList(nn.Linear(c, c) for _ in range(num_layers))

    def forward(self, x):  # channels-last
        y = self.norm(x, self.fcs[0].weight.dtype)
        for fc in self.fcs:
            y = _gelu(_dense(fc, y))
        return x + y


class SCAligner(nn.Module):
    FLAX_NAMES = {"blocks": "ResMLP"}

    def __init__(self, c: int, num_blocks: int, num_layers: int):
        super().__init__()
        self.blocks = nn.ModuleList(ResMLP(c, num_layers)
                                    for _ in range(num_blocks))

    def forward(self, x):
        x = _cl(x)
        for block in self.blocks:
            x = block(x)
        return _cf(x)


class DeformConv2d(nn.Module):
    """Deformable k x k conv: ``kernel`` (k, k, C, F) and ``bias`` (F,) in
    flax's layout, the offset conv's 2 k^2 channels (dy, dx) per tap in
    row-major tap order."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3):
        super().__init__()
        self.k = int(kernel)
        self.offset_conv = nn.Conv2d(in_ch, 2 * self.k * self.k, self.k,
                                     padding=self.k // 2)
        self.kernel = nn.Parameter(torch.zeros(self.k, self.k, in_ch, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.flax_reinit_()

    def flax_init_(self, g):
        """lecun_normal ``kernel`` (fan_in k^2 C), zero ``bias``, drawn from
        ``g`` on its device."""
        std = math.sqrt(1.0 / self.kernel[..., 0].numel()) / 0.87962566103423978
        t = torch.empty(self.kernel.shape, dtype=torch.float32, device=g.device)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
        self.kernel.copy_(t)
        self.bias.zero_()

    @torch.no_grad()
    def flax_reinit_(self):
        """The offset conv starts at zero."""
        self.offset_conv.weight.zero_()
        self.offset_conv.bias.zero_()

    def forward(self, x):
        b, c, h, w = x.shape
        kk = self.k * self.k
        off = _conv(self.offset_conv, x).float()
        off = _cl(off).reshape(b, h, w, kk, 2)
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=x.device),
            torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
        half = (self.k - 1) / 2.0
        taps = torch.arange(kk, device=x.device)
        dy = (taps // self.k).float() - half
        dx = (taps % self.k).float() - half
        # one grid per (map, tap): (B * k^2, H, W), map b at b * k^2 + t
        sy = (gy + dy[:, None, None] + off[..., 0].permute(0, 3, 1, 2)).flatten(0, 1)
        sx = (gx + dx[:, None, None] + off[..., 1].permute(0, 3, 1, 2)).flatten(0, 1)
        src = torch.arange(b, device=x.device).repeat_interleave(kk)
        sampled = grid_sample_bilinear(_cl(x.float()), sx, sy, src_index=src)
        dt = self.kernel.dtype
        out = torch.einsum("bthwc,tcf->bfhw",
                           sampled.reshape(b, kk, h, w, c).to(dt),
                           self.kernel.reshape(kk, c, -1).to(dt))
        return out + self.bias.to(dt)[:, None, None]


class ResidualBlock(nn.Module):
    """conv - BN - ReLU - conv - BN, plus the input, ReLU; ``deform`` makes
    both convs deformable."""

    FLAX_NAMES = {"bn1": "BatchNorm_0", "bn2": "BatchNorm_1"}

    def __init__(self, c: int, kernel: int = 3, deform: bool = False):
        super().__init__()
        self.deform = deform
        if deform:
            self.conv1, self.conv2 = (DeformConv2d(c, c, kernel) for _ in range(2))
        else:
            self.conv1, self.conv2 = (nn.Conv2d(c, c, kernel, padding=kernel // 2)
                                      for _ in range(2))
        self.bn1, self.bn2 = BatchNorm2d(c), BatchNorm2d(c)

    def _c(self, conv, x):
        return conv(x) if self.deform else _conv(conv, x)

    def forward(self, x):
        y = torch.relu(self.bn1(self._c(self.conv1, x)))
        y = self.bn2(self._c(self.conv2, y))
        return torch.relu(y + x)


class ResAligner(nn.Module):
    FLAX_NAMES = {"blocks": "ResidualBlock"}

    def __init__(self, c: int, num_blocks: int, kernel: int, deform: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList(ResidualBlock(c, kernel, deform)
                                    for _ in range(num_blocks))

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class ChannelAttention(nn.Module):
    """sigmoid(mlp(mean) + mlp(max)) over the pixels, a c // 16 bottleneck."""

    FLAX_NAMES = {"fc1": "Dense_0", "fc2": "Dense_1"}

    def __init__(self, c: int, ratio: int = 16):
        super().__init__()
        hidden = max(c // ratio, 1)
        self.fc1 = nn.Linear(c, hidden, bias=False)
        self.fc2 = nn.Linear(hidden, c, bias=False)

    def forward(self, x):
        def mlp(v):
            return _dense(self.fc2, torch.relu(_dense(self.fc1, v)))

        gate = torch.sigmoid(mlp(x.mean((2, 3))) + mlp(x.amax((2, 3))))
        return gate[:, :, None, None]


class SpatialAttention(nn.Module):
    """sigmoid of a bias-free k x k conv over the [mean, max] channel maps."""

    FLAX_NAMES = {"conv": "Conv_0"}

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.conv = nn.Conv2d(2, 1, kernel, padding=kernel // 2, bias=False)

    def forward(self, x):
        stacked = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return torch.sigmoid(_conv(self.conv, stacked))


class CBAMBlock(nn.Module):
    """1x1 conv residual block with channel then spatial attention."""

    FLAX_NAMES = {"conv1": "Conv_0", "conv2": "Conv_1", "bn1": "BatchNorm_0",
                  "bn2": "BatchNorm_1", "ca": "ChannelAttention_0",
                  "sa": "SpatialAttention_0"}

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1, bias=False)
        self.conv2 = nn.Conv2d(c, c, 1, bias=False)
        self.bn1, self.bn2 = BatchNorm2d(c), BatchNorm2d(c)
        self.ca, self.sa = ChannelAttention(c), SpatialAttention()

    def forward(self, x):
        y = torch.relu(self.bn1(_conv(self.conv1, x)))
        y = self.bn2(_conv(self.conv2, y))
        y = self.ca(y) * y
        y = self.sa(y) * y
        return torch.relu(y + x)


class XCA(nn.Module):
    """Cross-covariance attention: per head a (d, d) attention over the
    channels from l2-normalised q / k (over the tokens), times a learned
    ``temperature``."""

    FLAX_NAMES = {"qkv": "Dense_0", "proj": "Dense_1"}

    def __init__(self, c: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.temperature = nn.Parameter(torch.ones(heads, 1, 1))
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def flax_init_(self, g):
        self.temperature.fill_(1.0)

    def forward(self, x):  # (B, N, C)
        b, n, c = x.shape
        qkv = _dense(self.qkv, x).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = (qkv[:, :, i].permute(0, 2, 3, 1) for i in range(3))

        def l2(a):
            af = a.float()
            return (af / af.norm(dim=-1, keepdim=True).clamp_min(1e-6)).to(a.dtype)

        q, k = l2(q), l2(k)
        attn = torch.einsum("bhcn,bhdn->bhcd", q, k) * self.temperature.to(q.dtype)
        out = torch.einsum("bhcd,bhdn->bhcn", torch.softmax(attn, dim=-1), v)
        return _dense(self.proj, out.permute(0, 3, 1, 2).reshape(b, n, c))


class SDTAAligner(nn.Module):
    """Per block a ConvEncoder (depthwise 7x7, LayerNorm, GELU MLP, plus
    the input), then an SDTA encoder (a depthwise 3x3 on the second half of
    the channels, XCA over the pixels after a LayerNorm, a LayerNorm GELU
    MLP, each plus its input). Block i's layers are ``Conv_{2i}`` /
    ``Conv_{2i+1}``, ``LayerNorm_{3i..3i+2}``, ``Dense_{4i..4i+3}`` and
    ``XCA_i``, as flax numbers them."""

    FLAX_NAMES = {"convs": "Conv", "norms": "LayerNorm", "fcs": "Dense",
                  "xcas": "XCA"}

    def __init__(self, c: int, num_blocks: int):
        super().__init__()
        if c % 2:
            raise ValueError(f"SDTA splits the channels in two: {c}")
        half = c - c // 2
        self.num_blocks = num_blocks
        self.convs = nn.ModuleList(
            m for _ in range(num_blocks)
            for m in (nn.Conv2d(c, c, 7, padding=3, groups=c),
                      nn.Conv2d(half, half, 3, padding=1, groups=half)))
        self.norms = nn.ModuleList(LayerNorm(c) for _ in range(3 * num_blocks))
        self.fcs = nn.ModuleList(
            m for _ in range(2 * num_blocks)
            for m in (nn.Linear(c, 4 * c), nn.Linear(4 * c, c)))
        self.xcas = nn.ModuleList(XCA(c) for _ in range(num_blocks))

    def forward(self, x):
        b, c, h, w = x.shape
        for i in range(self.num_blocks):
            fc = self.fcs[4 * i:4 * i + 4]
            norm = self.norms[3 * i:3 * i + 3]
            dt = fc[0].weight.dtype
            y = _cl(_conv(self.convs[2 * i], x))
            y = _dense(fc[1], _gelu(_dense(fc[0], norm[0](y, dt))))
            x = x + _cf(y)
            split = c // 2
            d = _conv(self.convs[2 * i + 1], x[:, split:])
            x = torch.cat([x[:, :split], d.to(x.dtype)], dim=1)
            flat = _cl(x).reshape(b, h * w, c)
            flat = flat + self.xcas[i](norm[1](flat, dt))
            y = _dense(fc[3], _gelu(_dense(fc[2], norm[2](flat, dt))))
            x = _cf((flat + y).reshape(b, h, w, c))
        return x


class AlignNet(nn.Module):
    """The dispatcher of ``cfg['core_method']`` on maps of ``c`` channels."""

    METHODS = ("identity", "scaligner", "resnet1x1", "resnet3x3", "cbam",
               "convnext", "sdta")

    def __init__(self, cfg: dict, c: int):
        super().__init__()
        self.method = cfg["core_method"]
        args = dict(cfg.get("args", {}))
        m = self.method
        if m == "scaligner":
            self.SCAligner_0 = SCAligner(c, int(args["num_of_blocks"]),
                                         int(args.get("num_of_layers", 2)))
        elif m in ("resnet1x1", "resnet3x3"):
            self.ResAligner_0 = ResAligner(
                c, int(args["num_of_blocks"]), 1 if m == "resnet1x1" else 3,
                bool(args.get("deform", False)))
        elif m == "cbam":
            self.CBAMBlock = nn.ModuleList(
                CBAMBlock(c) for _ in range(int(args["num_of_blocks"])))
        elif m == "convnext":
            n = int(args.get("num_of_blocks", args.get("depth", 2)))
            self._ConvNeXtBlock = nn.ModuleList(ConvNeXtBlock(c) for _ in range(n))
        elif m == "sdta":
            self.SDTAAligner_0 = SDTAAligner(c, int(args["num_of_blocks"]))
        elif m != "identity":
            raise ValueError(f"unknown alignnet core_method '{m}'")

    def forward(self, x):
        for child in self.children():
            if isinstance(child, nn.ModuleList):
                for block in child:
                    x = block(x)
            else:
                x = child(x)
        return x


class DCNNet(nn.Module):
    """``n_blocks`` deformable convs of ``out_channels[i]`` and
    ``kernel_size[i]``."""

    FLAX_NAMES = {"convs": "DeformConv2d"}

    def __init__(self, cfg: dict, in_ch: int):
        super().__init__()
        convs = []
        for i in range(int(cfg.get("n_blocks", 1))):
            out = int(cfg["out_channels"][i])
            convs.append(DeformConv2d(in_ch, out, int(cfg["kernel_size"][i])))
            in_ch = out
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return x


class AutoEncoder(nn.Module):
    """Per level a bias-free stride-2 3x3 conv (padding 1) and a 3x3 conv
    halving the channels, each + BN + ReLU; then per level a 2x2 stride-2
    transposed conv doubling them and a 3x3 conv, each + BN + ReLU."""

    FLAX_NAMES = {"convs": "Conv", "bns": "BatchNorm", "deconvs": "ConvTranspose"}

    def __init__(self, feature_num: int, layer_num: int):
        super().__init__()
        self.layer_num = layer_num
        enc, dec, deconvs, c = [], [], [], feature_num
        for _ in range(layer_num):
            enc += [nn.Conv2d(c, c, 3, stride=2, padding=1, bias=False),
                    nn.Conv2d(c, c // 2, 3, padding=1, bias=False)]
            c //= 2
        widths = []
        for _ in range(layer_num):
            deconvs.append(nn.ConvTranspose2d(c, 2 * c, 2, stride=2, bias=False))
            c *= 2
            dec.append(nn.Conv2d(c, c, 3, padding=1, bias=False))
            widths.append(c)
        self.convs = nn.ModuleList(enc + dec)
        self.deconvs = nn.ModuleList(deconvs)
        self.bns = nn.ModuleList(BatchNorm2d(m.out_channels) for m in enc + [
            m for pair in zip(deconvs, dec) for m in pair])

    def forward(self, x):
        n = self.layer_num
        for i in range(2 * n):
            x = torch.relu(self.bns[i](_conv(self.convs[i], x)))
        for i in range(n):
            x = torch.relu(self.bns[2 * n + 2 * i](_conv(self.deconvs[i], x)))
            x = torch.relu(self.bns[2 * n + 2 * i + 1](
                _conv(self.convs[2 * n + i], x)))
        return x
