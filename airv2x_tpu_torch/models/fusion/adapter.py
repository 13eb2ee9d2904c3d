"""STAMP feature-space adapters (counterpart of
airv2x_tpu/models/fusion/adapter.py).

Each agent type translates its BEV map into the shared "protocol" feature
space. The geometry between the agent's native grid and the protocol grid
(``_geometry``) is a bilinear resize by the resolution ratio plus a centre
crop or pad to the protocol extent. Variants: identity (channels resized
linearly where they differ), a 1x1 conv, a pixel-wise fully-connected map,
a ConvNeXt-block stack (which, as the reference, applies no crop or pad)
and deformable spatial attention (DSA) with mixed RoPE.

Modules take and return NCHW maps; their Linears and LayerNorms act
channels-last, each Linear in its weight's dtype and each LayerNorm with
flax's f32 statistics (``fusion/v2xvit.py:LayerNorm``). The resize is
``jax.image.resize(..., "bilinear")``'s: antialiased where it shrinks
(``fusion/where2comm.py:_resize_weights``), one contraction per axis that
changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.v2xvit import LayerNorm, _dense
from airv2x_tpu_torch.models.fusion.where2comm import _resize_weights


def _geometry(args: dict):
    """(resize factors (x, y), pads (left, right, top, bottom)) from the
    in / out ranges and feature shapes; a negative pad crops."""
    in_r = args["in_cav_lidar_range"]
    out_r = args["out_cav_lidar_range"]
    in_shape = args["in_feature_shape"]  # (H, W)
    out_shape = args["out_feature_shape"]

    in_range = np.array([in_r[3] - in_r[0], in_r[4] - in_r[1]])  # (x, y)
    out_range = np.array([out_r[3] - out_r[0], out_r[4] - out_r[1]])
    in_ratio = np.array([in_shape[1], in_shape[0]]) / in_range  # px per m
    out_ratio = np.array([out_shape[1], out_shape[0]]) / out_range
    feat_ratio = out_ratio / in_ratio

    left_new = in_r[0] * in_ratio[0] * feat_ratio[0]
    right_new = in_r[3] * in_ratio[0] * feat_ratio[0]
    top_new = in_r[1] * in_ratio[1] * feat_ratio[1]
    bottom_new = in_r[4] * in_ratio[1] * feat_ratio[1]
    left_t = out_r[0] * out_ratio[0]
    right_t = out_r[3] * out_ratio[0]
    top_t = out_r[1] * out_ratio[1]
    bottom_t = out_r[4] * out_ratio[1]
    pads = (round(left_new - left_t), round(right_t - right_new),
            round(top_new - top_t), round(bottom_t - bottom_new))
    return feat_ratio, pads


def _resized_hw(hw, feat_ratio):
    return (int(round(hw[0] * feat_ratio[1])),
            int(round(hw[1] * feat_ratio[0])))


def _resize_axis(x, dim: int, n_out: int):
    """x resized along ``dim`` to ``n_out`` with ``jax.image.resize``'s
    bilinear weights (no-op where the size holds)."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    wts = _resize_weights(n_in, n_out, x.device).to(x.dtype)
    return torch.tensordot(x.movedim(dim, -1), wts, dims=1).movedim(-1, dim)


def _resize_by(x, feat_ratio):
    """(N, C, H, W) -> (N, C, round(H * fy), round(W * fx))."""
    h, w = _resized_hw(x.shape[-2:], feat_ratio)
    return _resize_axis(_resize_axis(x, -2, h), -1, w)


def _crop_pad(x, pads):
    """Zero-pad (positive) or crop (negative) the width, then the height."""
    left, right, top, bottom = pads
    for dim, lo, hi in ((-1, left, right), (-2, top, bottom)):
        if lo > 0 or hi > 0:
            cfg = [0, 0] * (-dim - 1) + [max(lo, 0), max(hi, 0)]
            x = F.pad(x, cfg)
        if lo < 0:
            x = x.narrow(dim, -lo, x.shape[dim] + lo)
        if hi < 0:
            x = x.narrow(dim, 0, x.shape[dim] + hi)
    return x


def _conv1x1(conv: nn.Conv2d, x):
    return conv(x.to(conv.weight.dtype))


class AdapterIdentity(nn.Module):
    def __init__(self, args: dict):
        super().__init__()
        self.args = args
        self.feat_ratio, self.pads = _geometry(args)

    def forward(self, x):
        x = _resize_by(x, self.feat_ratio)
        # a channel-count change: linear interpolation along the channels
        x = _resize_axis(x, 1, int(self.args["out_channels"]))
        return _crop_pad(x, self.pads)


class AdapterConv(nn.Module):
    FLAX_NAMES = {"conv": "Conv_0"}

    def __init__(self, args: dict):
        super().__init__()
        self.feat_ratio, self.pads = _geometry(args)
        self.conv = nn.Conv2d(int(args["in_channels"]),
                              int(args["out_channels"]), 1)

    def forward(self, x):
        return _crop_pad(_conv1x1(self.conv, _resize_by(x, self.feat_ratio)),
                         self.pads)


class AdapterFC(nn.Module):
    """A per-pixel Linear at the resized grid: ``weights`` (h, w, in, out)
    and ``biases`` (h, w, out), flax's layout."""

    def __init__(self, args: dict):
        super().__init__()
        self.feat_ratio, self.pads = _geometry(args)
        h, w = _resized_hw(args["in_feature_shape"], self.feat_ratio)
        cin, cout = int(args["in_channels"]), int(args["out_channels"])
        self.weights = nn.Parameter(torch.zeros(h, w, cin, cout))
        self.biases = nn.Parameter(torch.zeros(h, w, cout))

    def flax_init_(self, g):
        """flax's ``kaiming_uniform`` (fan_in h * w * in) and zero biases."""
        h, w, cin, _ = self.weights.shape
        bound = math.sqrt(6.0 / (h * w * cin))
        self.weights.copy_(torch.empty(self.weights.shape).uniform_(
            -bound, bound, generator=g))
        self.biases.zero_()

    def forward(self, x):
        x = _resize_by(x, self.feat_ratio)
        y = torch.einsum("nchw,hwco->nohw", x, self.weights.to(x.dtype))
        y = y + self.biases.to(x.dtype).permute(2, 0, 1)
        return _crop_pad(y, self.pads)


class ConvNeXtBlock(nn.Module):
    """Depthwise 7x7 conv -> LayerNorm -> Linear (4 dim) -> tanh GELU ->
    Linear (dim) -> times ``gamma``, plus the input."""

    FLAX_NAMES = {"dwconv": "Conv_0", "norm": "LayerNorm_0", "fc1": "Dense_0",
                  "fc2": "Dense_1"}

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def flax_init_(self, g):
        self.gamma.fill_(1e-6)

    def forward(self, x):
        dt = self.dwconv.weight.dtype
        y = self.dwconv(x.to(dt)).permute(0, 2, 3, 1)
        y = _dense(self.fc1, self.norm(y, dt))
        y = _dense(self.fc2, F.gelu(y, approximate="tanh"))
        return x + (self.gamma.to(x.dtype) * y).permute(0, 3, 1, 2)


class AdapterConvNext(nn.Module):
    """``early_scale`` x input, resized (before, or with ``late_upsample``
    after, the stack), 1x1 conv to ``dim``, ``depth`` (or
    ``num_of_blocks``) ConvNeXt blocks, 1x1 conv to ``out_channels``; no
    crop or pad (the reference's forward applies none)."""

    FLAX_NAMES = {"conv_in": "Conv_0", "blocks": "_ConvNeXtBlock",
                  "conv_out": "Conv_1"}

    def __init__(self, args: dict):
        super().__init__()
        sub = args.get("submodule_args", {})
        self.feat_ratio, _ = _geometry(args)
        self.early_scale = sub.get("early_scale", 1.0)
        self.late = bool(sub.get("late_upsample", False))
        dim = int(sub.get("dim", 64))
        depth = int(sub.get("depth", sub.get("num_of_blocks", 2)))
        self.conv_in = nn.Conv2d(int(args["in_channels"]), dim, 1)
        self.blocks = nn.ModuleList(ConvNeXtBlock(dim) for _ in range(depth))
        self.conv_out = nn.Conv2d(dim, int(args["out_channels"]), 1)

    def forward(self, x):
        x = x * self.early_scale
        if not self.late:
            x = _resize_by(x, self.feat_ratio)
        x = _conv1x1(self.conv_in, x)
        for block in self.blocks:
            x = block(x)
        x = _conv1x1(self.conv_out, x)
        if self.late:
            x = _resize_by(x, self.feat_ratio)
        return x


def _bilinear_sample_points(value, locs):
    """value (B, H, W, C); locs (B, Q, P, 2) normalized [0, 1] (x, y) ->
    (B, Q, P, C) bilinear samples, zero outside the map."""
    b, h, w, c = value.shape
    x = locs[..., 0] * w - 0.5
    y = locs[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    flat = value.reshape(b, h * w, c)
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)

    def gather(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        g = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return g.reshape(idx.shape + (c,)) * ok[..., None].to(value.dtype)

    return (gather(y0i, x0i) * (1 - fx) * (1 - fy)
            + gather(y0i, x0i + 1) * fx * (1 - fy)
            + gather(y0i + 1, x0i) * (1 - fx) * fy
            + gather(y0i + 1, x0i + 1) * fx * fy)


def _dsa_offset_bias(num_heads: int, num_points: int) -> np.ndarray:
    """The sampling offsets' directional ring bias: per head a unit
    direction (its larger coordinate 1), scaled by 1 .. num_points."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None], (1, num_points, 1))
    grid *= np.arange(1, num_points + 1, dtype=np.float32)[None, :, None]
    return grid.reshape(-1)


class DSALayer(nn.Module):
    """One deformable spatial attention layer: each query predicts per-head
    sampling offsets around its reference point, samples the projected
    value map there bilinearly and mixes the samples by a softmax over the
    points; an output Linear plus the query."""

    FLAX_NAMES = {"offsets": "Dense_0", "weights": "Dense_1",
                  "value": "Dense_2", "out": "Dense_3"}

    def __init__(self, in_channels: int, out_channels: int, num_heads: int = 8,
                 num_points: int = 4):
        super().__init__()
        if out_channels % num_heads:
            raise ValueError(f"DSA out_channels={out_channels} must be "
                             f"divisible by num_heads={num_heads}")
        self.nh, self.npt = num_heads, num_points
        self.offsets = nn.Linear(out_channels, num_heads * num_points * 2)
        self.weights = nn.Linear(out_channels, num_heads * num_points)
        self.value = nn.Linear(in_channels, out_channels)
        self.out = nn.Linear(out_channels, out_channels)

    def flax_reinit_(self):
        """flax's initialisers of the offset and weight Linears, which
        differ from the defaults: zero kernels, the offsets' ring bias."""
        for lin in (self.offsets, self.weights):
            lin.weight.zero_()
            lin.bias.zero_()
        self.offsets.bias.copy_(torch.from_numpy(
            _dsa_offset_bias(self.nh, self.npt)))

    def forward(self, query, value_map, spatial_shape):
        """query (B, Q, C_out), value_map (B, H * W, C_in) -> (B, Q,
        C_out)."""
        b, q, _ = query.shape
        h, w = spatial_shape
        nh, npt = self.nh, self.npt
        offsets = _dense(self.offsets, query).reshape(b, q, nh, npt, 2)
        weights = torch.softmax(
            _dense(self.weights, query).reshape(b, q, nh, npt), dim=-1)
        value = _dense(self.value, value_map)
        value = value.reshape(b, h, w, nh, -1)
        ys, xs = torch.meshgrid(
            (torch.arange(h, device=query.device) + 0.5) / h,
            (torch.arange(w, device=query.device) + 0.5) / w, indexing="ij")
        ref = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)  # (Q, 2)
        norm = torch.tensor([w, h], dtype=offsets.dtype, device=query.device)
        locs = ref[None, :, None, None, :] + offsets / norm
        sampled = []
        for head in range(nh):
            s = _bilinear_sample_points(value[..., head, :], locs[:, :, head])
            sampled.append((s * weights[:, :, head, :, None]).sum(dim=2))
        return _dense(self.out, torch.cat(sampled, dim=-1)) + query


class AdapterDSA(nn.Module):
    """A 1x1-conv query map at the protocol resolution refined by
    ``n_layers`` deformable attention layers over the source map, the query
    rotated by learnable 2-D RoPE frequencies (``rope_freqs``, per layer and
    head) before each; then crop or pad."""

    FLAX_NAMES = {"query_conv": "Conv_0", "layers": "dsa_layer"}

    def __init__(self, args: dict):
        super().__init__()
        sub = args.get("submodule_args", {})
        self.n_layers = int(sub.get("n_layers", 2))
        self.num_heads = int(sub.get("num_heads", 8))
        num_points = int(sub.get("num_points", 4))
        self.theta = float(sub.get("rope_theta", 10.0))
        out_c = int(args["out_channels"])
        self.out_c, self.dh = out_c, out_c // self.num_heads
        self.feat_ratio, self.pads = _geometry(args)
        self.query_conv = nn.Conv2d(int(args["in_channels"]), out_c, 1)
        self.rope_freqs = nn.Parameter(torch.zeros(
            2, self.n_layers, self.num_heads * (self.dh // 2)))
        self.layers = nn.ModuleList(
            DSALayer(int(args["in_channels"]), out_c, self.num_heads, num_points)
            for _ in range(self.n_layers))

    def flax_init_(self, g):
        """Per (layer, head, pair) a frequency of magnitude theta^-k in a
        uniformly drawn 2-D direction (flax's ``freq_init``; drawn from
        ``g``, not JAX's keys)."""
        k = self.dh // 2
        mags = self.theta ** (-torch.arange(k, dtype=torch.float32) / max(k, 1))
        ang = torch.empty(self.n_layers, self.num_heads, k).uniform_(
            0.0, 2 * math.pi, generator=g)
        freqs = torch.stack([mags * torch.cos(ang), mags * torch.sin(ang)])
        self.rope_freqs.copy_(freqs.reshape(self.rope_freqs.shape))

    def forward(self, x):
        b, _, src_h, src_w = x.shape
        query_map = _conv1x1(self.query_conv, _resize_by(x, self.feat_ratio))
        qh, qw = query_map.shape[-2:]
        out_c, nh = self.out_c, self.num_heads
        dt = query_map.dtype
        q = query_map.permute(0, 2, 3, 1).reshape(b, qh * qw, out_c)
        key = x.permute(0, 2, 3, 1).reshape(b, src_h * src_w, x.shape[1])
        ys, xs = torch.meshgrid(
            torch.arange(qh, dtype=torch.float32, device=x.device),
            torch.arange(qw, dtype=torch.float32, device=x.device),
            indexing="ij")
        t_y, t_x = ys.reshape(-1), xs.reshape(-1)
        for i, layer in enumerate(self.layers):
            f = self.rope_freqs[:, i].reshape(2, nh, self.dh // 2)
            angle = f[0][None] * t_x[:, None, None] + f[1][None] * t_y[:, None, None]
            cos = torch.cos(angle).reshape(1, qh * qw, out_c // 2)
            sin = torch.sin(angle).reshape(1, qh * qw, out_c // 2)
            qr = q.reshape(b, qh * qw, out_c // 2, 2)
            q = torch.stack([qr[..., 0] * cos - qr[..., 1] * sin,
                             qr[..., 0] * sin + qr[..., 1] * cos],
                            -1).reshape(b, qh * qw, out_c).to(dt)
            q = layer(q, key, (src_h, src_w))
        out = q.reshape(b, qh, qw, out_c).permute(0, 3, 1, 2)
        return _crop_pad(out, self.pads)


VARIANTS = {"identity": AdapterIdentity, "adapterconv": AdapterConv,
            "adapterfc": AdapterFC, "adapterconvnext": AdapterConvNext,
            "adapterdsa": AdapterDSA}


class Adapter(nn.Module):
    """The variant ``cfg['core_method']`` names, on ``cfg['args']`` (flax
    scope ``<variant class>_0``: each class bears its flax twin's name)."""

    def __init__(self, cfg: dict):
        super().__init__()
        name = cfg["core_method"]
        if name not in VARIANTS:
            raise NotImplementedError(f"adapter '{name}'")
        cls = VARIANTS[name]
        self.core = cls(cfg["args"])
        self.FLAX_NAMES = {"core": f"{cls.__name__}_0"}

    def forward(self, x):
        return self.core(x)
