"""SCOPE's collaboration and temporal machinery, eval mode (counterpart of
airv2x_tpu/models/fusion/scope.py), channels-first.

  * ``ScopeCommunication``: gaussian-smoothed max-sigmoid confidence maps,
    threshold masks where every even agent slot sends its whole map (the
    reference's quirk), the ego mask's fraction as the comm rate, and the
    smoothed maps the deformable fusion ranks its queries by;
  * ``atten_fusion`` / ``max_fusion``: the ATTEN and MAX aggregation modes
    (the Deform mode is ``fusion/msda.py:DeformableQueryRefine``);
  * ``SpatialAttentionMTF`` -> ``SyncLSTM`` (``MotionLSTM`` over
    ``STPNMotionLSTM`` pyramids) = ``TemporalFusionLSTM``: the pyramid-gated
    ConvLSTM over the ego history, run from the oldest frame. The reference
    quirk is kept: the output gate applies ``V_o`` to x, not to h;
  * ``ScopeLateFusion``: a per-pixel softmax over the three confidence maps
    blends the temporal, ego and collaborative features.

The gaussian is Where2comm's (unnormalised 1 / (2 pi sigma), in the input's
dtype). The temporal BatchNorms use eps 1e-5 and flax momentum 0.9, not the
backbone's 1e-3 and 0.99.
The LSTM's raw parameters (``b_*`` (1, C, H, W), ``init_c`` (C, H, W)) stay
f32 under the serving cast, as the JAX package keeps its parameters; the
weight bridge permutes them from flax's channels-last layout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.common import NEG_INF
from airv2x_tpu_torch.models.fusion.where2comm import gaussian_smooth
from airv2x_tpu_torch.models.nn import BatchNorm2d

LSTM_BN_EPS = 1e-5
LSTM_BN_MOMENTUM = 0.9  # flax coefficient (torch 0.1), as the JAX package


def smoothed_confidence(psm, k_size: int, c_sigma: float):
    """(..., A, H, W) logits -> (..., H, W): the max sigmoid over the anchor
    channels, gaussian-smoothed with SAME padding, in psm's dtype."""
    return gaussian_smooth(torch.sigmoid(psm).amax(dim=-3), k_size, c_sigma)


class ScopeCommunication(nn.Module):
    def __init__(self, thre: float, k_size: int = 5, c_sigma: float = 1.0):
        super().__init__()
        self.thre, self.k_size, self.c_sigma = thre, k_size, c_sigma

    def forward(self, psm, agent_mask):
        """psm (B, L, A, H, W) single-agent logits -> (masks (B, L, H, W),
        comm rate (f32 scalar), smoothed confidence maps (B, L, H, W)),
        masks and maps zero for absent agents."""
        smooth = smoothed_confidence(psm, self.k_size, self.c_sigma)
        mask = (smooth > self.thre).to(psm.dtype)
        l, h, w = mask.shape[1:]
        even = (torch.arange(l, device=mask.device) % 2 == 0)[None, :, None, None]
        mask = torch.where(even, torch.ones_like(mask), mask)
        rate = (mask[:, 0].float().sum((1, 2)) / (h * w)).mean()
        am = agent_mask[:, :, None, None].to(mask.dtype)
        return mask * am, rate, smooth * am


def atten_fusion(x, agent_mask=None):
    """Per-pixel scaled-dot self-attention across the agent slots, the ego
    row kept. x (B, L, H, W, C); ``agent_mask`` (B, L) leaves absent slots
    out of the softmax -> (B, H, W, C)."""
    b, l, h, w, c = x.shape
    seq = x.permute(0, 2, 3, 1, 4).reshape(b, h * w, l, c)
    score = torch.einsum("bpic,bpjc->bpij", seq, seq) / math.sqrt(c)
    if agent_mask is not None:
        score = score.masked_fill(~agent_mask[:, None, None, :].bool(), NEG_INF)
    attn = torch.softmax(score, dim=-1)
    out = torch.einsum("bpij,bpjc->bpic", attn, seq)[:, :, 0]
    return out.reshape(b, h, w, c)


def max_fusion(x):
    """The maximum over the agent slots: (B, L, ...) -> (B, ...)."""
    return x.amax(dim=1)


def _cbr(conv, bn, x):
    """conv -> BN -> ReLU, x cast to the conv's dtype."""
    return torch.relu(bn(conv(x.to(conv.weight.dtype))))


class SpatialAttentionMTF(nn.Module):
    """A 7x7 conv over the channel mean and max of the current frame plus
    those of the summed earlier frames gates each earlier frame against the
    tanh of the current one."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, curr, prev):
        """curr (B, 1, C, H, W), prev (B, T-1, C, H, W) -> gated prev."""
        c = curr[:, 0]
        c_stats = torch.cat([c.mean(1, keepdim=True), c.amax(1, keepdim=True)], 1)
        ps = prev.sum(dim=1)
        p_stats = torch.cat([ps.mean(1, keepdim=True), ps.amax(1, keepdim=True)], 1)
        s = c_stats + p_stats
        gate = torch.sigmoid(self.conv1(s.to(self.conv1.weight.dtype)))[:, None]
        return (1.0 - gate) * torch.tanh(curr) + gate * prev


class STPNMotionLSTM(nn.Module):
    """Two stride-2 levels of conv-BN-ReLU pairs and two nearest-upsampled
    skip merges back to the input's size: c -> 2c -> 4c -> 2c -> c."""

    # (name, input / c, output / c, stride)
    LAYERS = (("1_1", 1, 2, 2), ("1_2", 2, 2, 1), ("2_1", 2, 4, 2),
              ("2_2", 4, 4, 1), ("7_1", 6, 2, 1), ("7_2", 2, 2, 1),
              ("8_1", 3, 1, 1), ("8_2", 1, 1, 1))

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        for name, cin, cout, stride in self.LAYERS:
            self.add_module(f"conv{name}", nn.Conv2d(
                cin * c, cout * c, 3, stride=stride, padding=1))
            self.add_module(f"bn{name}", BatchNorm2d(
                cout * c, eps=LSTM_BN_EPS, momentum=LSTM_BN_MOMENTUM))

    def _cbr(self, name, x):
        return _cbr(getattr(self, f"conv{name}"), getattr(self, f"bn{name}"), x)

    def forward(self, x):
        x = x.to(self.conv1_1.weight.dtype)
        x1 = self._cbr("1_2", self._cbr("1_1", x))
        x2 = self._cbr("2_2", self._cbr("2_1", x1))
        up = F.interpolate(x2, scale_factor=2, mode="nearest")
        x7 = self._cbr("7_2", self._cbr("7_1", torch.cat([up, x1], 1)))
        up = F.interpolate(x7, scale_factor=2, mode="nearest")
        return self._cbr("8_2", self._cbr("8_1", torch.cat([up, x], 1)))


class MotionLSTM(nn.Module):
    """ConvLSTM cell with STPN pyramids for U (on x) and V (on h); the output
    gate is sigmoid(U_o(x) + V_o(x) + b_o), V_o on x (the reference's)."""

    GATES = ("i", "f", "c", "o")
    FLAX_LAYOUT = {f"b_{g}": (0, 3, 1, 2) for g in GATES}  # (1, H, W, C)
    F32_PARAMS = tuple(FLAX_LAYOUT)

    def __init__(self, channels: int, height: int, width: int):
        super().__init__()
        for g in self.GATES:
            self.add_module(f"u_{g}", STPNMotionLSTM(channels))
            self.add_module(f"v_{g}", STPNMotionLSTM(channels))
            self.register_parameter(f"b_{g}", nn.Parameter(
                torch.zeros(1, channels, height, width)))

    def flax_init_(self, g: torch.Generator) -> None:
        for name in self.F32_PARAMS:
            getattr(self, name).zero_()

    def _pre(self, g, x, h):
        return getattr(self, f"u_{g}")(x) + getattr(self, f"v_{g}")(h) \
            + getattr(self, f"b_{g}")

    def forward(self, x, h, c):
        i = torch.sigmoid(self._pre("i", x, h))
        f = torch.sigmoid(self._pre("f", x, h))
        g = torch.tanh(self._pre("c", x, h))
        o = torch.sigmoid(self._pre("o", x, x))
        c_out = f * c + i * g
        return o * torch.tanh(c_out), c_out


class SyncLSTM(nn.Module):
    """Compress the frames' channels (conv-BN-ReLU twice, by ``ratio`` =
    int(sqrt(channel_size / compressed_size))), run the ``MotionLSTM`` cell
    from the oldest frame (h) and the learned ``init_c`` back to the current
    one, and decompress the last h."""

    FLAX_LAYOUT = {"init_c": (2, 0, 1)}  # (H, W, C)
    F32_PARAMS = ("init_c",)

    def __init__(self, channel_size: int, height: int, width: int,
                 compressed_size: int = 64):
        super().__init__()
        cs = compressed_size
        self.compress = cs != channel_size
        ratio = max(1, int((channel_size / cs) ** 0.5))
        if self.compress:
            for name, cin, cout in (("pre_1", channel_size, ratio * cs),
                                    ("pre_2", ratio * cs, cs),
                                    ("after_1", cs, ratio * cs),
                                    ("after_2", ratio * cs, channel_size)):
                self.add_module(f"conv_{name}", nn.Conv2d(cin, cout, 3, padding=1))
                self.add_module(f"bn_{name}", BatchNorm2d(
                    cout, eps=LSTM_BN_EPS, momentum=LSTM_BN_MOMENTUM))
        self.lstmcell = MotionLSTM(cs, height, width)
        self.init_c = nn.Parameter(torch.zeros(cs, height, width))

    def flax_init_(self, g: torch.Generator) -> None:
        """flax's ``uniform(1.0)``: U[0, 1)."""
        self.init_c.copy_(torch.rand(self.init_c.shape, generator=g,
                                     device=g.device))

    def _cbr(self, name, x):
        return _cbr(getattr(self, f"conv_{name}"), getattr(self, f"bn_{name}"), x)

    def forward(self, x):
        """x (B, T, C, H, W), index 0 the current frame -> (B, C, H, W)."""
        b, t = x.shape[:2]
        y = x
        if self.compress:
            y = self._cbr("pre_2", self._cbr("pre_1", x.flatten(0, 1)))
            y = y.reshape((b, t) + y.shape[1:])
        h = y[:, -1]
        c = self.init_c[None].expand_as(h)
        for i in range(t - 2, -1, -1):
            h, c = self.lstmcell(y[:, i], h, c)
        if self.compress:
            h = self._cbr("after_2", self._cbr("after_1", h))
        return h


class TemporalFusionLSTM(nn.Module):
    def __init__(self, channel: int, height: int, width: int):
        super().__init__()
        self.mtf_attention = SpatialAttentionMTF()
        self.sync_lstm = SyncLSTM(channel, height, width)

    def forward(self, hist):
        """hist (B, T, C, H, W), index 0 the current ego frame -> (B, C, H, W)."""
        curr, prev = hist[:, :1], hist[:, 1:]
        x_raw = torch.cat([curr, self.mtf_attention(curr, prev)], dim=1)
        return self.sync_lstm(x_raw)


class ScopeLateFusion(nn.Module):
    def __init__(self, k_size: int = 5, c_sigma: float = 1.0):
        super().__init__()
        self.k_size, self.c_sigma = k_size, c_sigma

    def forward(self, feats, psm_temporal, psm_ego, psm_agent):
        """feats [temporal, ego, cross] maps (B, C, H, W) and their (B, A,
        H, W) logits -> the confidence-softmax blend (B, C, H, W)."""
        total = torch.softmax(torch.stack([
            smoothed_confidence(p, self.k_size, self.c_sigma)
            for p in (psm_temporal, psm_ego, psm_agent)], dim=1), dim=1)
        return (feats[0] * total[:, 0:1] + feats[1] * total[:, 1:2]
                + feats[2] * total[:, 2:3])
