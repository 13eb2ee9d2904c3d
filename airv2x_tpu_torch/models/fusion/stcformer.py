"""How2comm's STCFormer fusion of one BEV scale (counterpart of
airv2x_tpu/models/fusion/stcformer.py), channels-last.

  * ``Decoupling``: each collaborator's map split into its exclusive part
    ((1 - ego confidence) x its confidence above the threshold) and its
    common part (ego confidence x its confidence above it); the two map
    lists carry the ego's confidence at slot 0;
  * ``TemporalAttention``: the ego's current map against every slot's
    (warped) history map, per pixel, with keys and values gated by a
    linear map of their global means per frame; the scores divide by
    sqrt(C) although q / k have 2C channels (the reference's), and absent
    slots' frames are masked out of the softmax;
  * the exclusive and common branches refined by deformable top-K query
    attention over the slots (``msda.DeformableQueryRefine``: 9 and 3
    sampling points), the queries a stable descending sort of the summed
    maps;
  * ``LateFusion``: the two branches blended by a softmax of two 1-channel
    3x3 gates.

Every convolution casts its input to its weight's dtype; the attention
scores and softmax are f32.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.how2comm import conv_cl
from airv2x_tpu_torch.models.fusion.msda import DeformableQueryRefine
from airv2x_tpu_torch.models.fusion.v2xvit import _dense


class Decoupling(nn.Module):
    def __init__(self, exclusive_thre: float = 0.01, common_thre: float = 0.01):
        super().__init__()
        self.exclusive_thre, self.common_thre = exclusive_thre, common_thre

    def forward(self, feat, conf):
        """feat (B, L, H, W, C), conf (B, L, H, W, 1) -> (exclusive and
        common collaborator maps (B, L-1, H, W, C), exclusive and common
        confidence maps (B, L, H, W, 1))."""
        ego_conf = conf[:, :1]
        exc_map_n = (1.0 - ego_conf) * conf[:, 1:]
        com_map_n = ego_conf * conf[:, 1:]
        exc = feat[:, 1:] * (exc_map_n > self.exclusive_thre).to(feat.dtype)
        com = feat[:, 1:] * (com_map_n > self.common_thre).to(feat.dtype)
        return (exc, com, torch.cat([ego_conf, exc_map_n], dim=1),
                torch.cat([ego_conf, com_map_n], dim=1))


class TemporalAttention(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        hd = 2 * channels
        self.channels = channels
        self.conv_query = nn.Conv2d(channels, hd, 3, padding=1)
        self.conv_key = nn.Conv2d(channels, hd, 3, padding=1)
        self.conv_value = nn.Conv2d(channels, hd, 3, padding=1)
        self.conv_temporal_key = nn.Linear(hd, hd)
        self.conv_temporal_value = nn.Linear(hd, hd)
        self.conv_feat = nn.Conv2d(hd, channels, 3, padding=1)

    def forward(self, hist, frame_mask=None):
        """hist (B, T, H, W, C), frame 0 the ego's current map; frame_mask
        (B, T) -> (B, H, W, C)."""
        b, t, h, w, c = hist.shape
        hd = 2 * self.channels
        flat = hist.reshape(b * t, h, w, c)
        q = conv_cl(self.conv_query, hist[:, 0])
        k = conv_cl(self.conv_key, flat).reshape(b, t, h, w, hd)
        v = conv_cl(self.conv_value, flat).reshape(b, t, h, w, hd)
        k = k * _dense(self.conv_temporal_key, k.mean((2, 3)))[:, :, None, None]
        v = v * _dense(self.conv_temporal_value, v.mean((2, 3)))[:, :, None, None]
        qf = q.reshape(b, h * w, 1, hd)
        kf = k.permute(0, 2, 3, 1, 4).reshape(b, h * w, t, hd)
        vf = v.permute(0, 2, 3, 1, 4).reshape(b, h * w, t, hd)
        score = torch.einsum("bpqd,bptd->bpqt", qf, kf).float() / math.sqrt(
            self.channels)
        if frame_mask is not None:
            score = score.masked_fill(~frame_mask[:, None, None, :].bool(), -1e9)
        attn = torch.softmax(score, dim=-1)
        ctx = torch.einsum("bpqt,bptd->bpqd", attn, vf.float()).reshape(b, h, w, hd)
        return conv_cl(self.conv_feat, ctx)


class LateFusion(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.gate_1 = nn.Conv2d(channels, 1, 3, padding=1)
        self.gate_2 = nn.Conv2d(channels, 1, 3, padding=1)

    def forward(self, exc, com):
        w = torch.softmax(torch.cat([conv_cl(self.gate_1, exc),
                                     conv_cl(self.gate_2, com)], dim=-1), dim=-1)
        return w[..., :1] * exc + w[..., 1:] * com


class STCFormer(nn.Module):
    def __init__(self, channels: int, level: int, num_queries: int = 500,
                 max_cav: int = 5):
        super().__init__()
        self.level = level
        self.decoupling = Decoupling()
        self.time_embedding = nn.Linear(1, channels)
        self.temporal_self_attention = TemporalAttention(channels)
        self.exclusive_encoder = DeformableQueryRefine(
            channels, n_points=9, num_queries=num_queries, max_cav=max_cav)
        self.common_encoder = DeformableQueryRefine(
            channels, n_points=3, num_queries=num_queries, max_cav=max_cav)
        self.late_fusion = LateFusion(channels)

    def forward(self, neighbor_feat, neighbor_conf, history_feat,
                agent_mask=None):
        """neighbor_feat (B, L, h, w, C) ego-frame slot maps; neighbor_conf
        (B, L, H0, W0, 1) level-0 confidence maps (every 2^level-th cell
        taken); history_feat (B, L, h, w, C) -> (fused ego map (B, h, w, C),
        [temporal, exclusive, common])."""
        if self.level > 0:
            s = 2 ** self.level
            neighbor_conf = neighbor_conf[:, :, ::s, ::s]
        exc, com, exc_map, com_map = self.decoupling(neighbor_feat, neighbor_conf)
        b = neighbor_feat.shape[0]
        hist = torch.cat([neighbor_feat[:, :1], history_feat], dim=1)
        t = hist.shape[1]
        delay = torch.cat([torch.zeros(1, device=hist.device),
                           -torch.ones(t - 1, device=hist.device)])[:, None]
        hist = hist + _dense(self.time_embedding, delay)[None, :, None, None, :]
        frame_mask = None
        if agent_mask is not None:
            frame_mask = torch.cat([
                torch.ones((b, 1), dtype=torch.bool, device=hist.device),
                agent_mask.bool()], dim=1)
        ego = self.temporal_self_attention(hist, frame_mask)
        ego_exc = self.exclusive_encoder(torch.cat([ego[:, None], exc], 1),
                                         exc_map[..., 0])
        ego_com = self.common_encoder(torch.cat([ego[:, None], com], 1),
                                      com_map[..., 0])
        return self.late_fusion(ego_exc, ego_com), [ego, ego_exc, ego_com]
