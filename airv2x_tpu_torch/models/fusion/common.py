"""Fusion building blocks over the dense agent axis (counterpart of
airv2x_tpu/models/fusion/common.py: ``masked_softmax``,
``ego_agent_attention``, ``max_fusion``, ``mean_fusion`` and
``PixelwiseSelfAttentionFusion``), NCHW per agent: x (B, L, C, H, W)."""

from __future__ import annotations

import math

import torch
from torch import nn

NEG_INF = -1e9


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor, dim: int):
    """Softmax along ``dim`` with False positions excluded."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    scores = scores - scores.amax(dim=dim, keepdim=True)
    w = torch.exp(scores) * mask.to(scores.dtype)
    return w / w.sum(dim=dim, keepdim=True).clamp_min(1e-9)


def ego_agent_attention(x: torch.Tensor, agent_mask: torch.Tensor):
    """Per-pixel scaled-dot attention from the ego agent (slot 0) over all
    agents. x (B, L, C, H, W); agent_mask (B, L) -> (B, C, H, W)."""
    c = x.shape[2]
    ego = x[:, 0]
    scores = torch.einsum("bchw,blchw->blhw", ego, x) / math.sqrt(c)
    attn = masked_softmax(scores, agent_mask[:, :, None, None], dim=1)
    return torch.einsum("blhw,blchw->bchw", attn, x)


def max_fusion(x: torch.Tensor, agent_mask: torch.Tensor):
    """Elementwise max over the present agents; a pixel where no agent is
    present (every value at the NEG_INF fill) is 0. x (B, L, C, H, W) ->
    (B, C, H, W)."""
    neg = torch.full((), NEG_INF, dtype=x.dtype, device=x.device)
    xm = torch.where(agent_mask[:, :, None, None, None], x, neg)
    out = xm.amax(dim=1)
    return torch.where(out <= neg / 2, torch.zeros_like(out), out)


def mean_fusion(x: torch.Tensor, agent_mask: torch.Tensor):
    """Mean over the present agents (at least one counted). x (B, L, C, H,
    W) -> (B, C, H, W)."""
    m = agent_mask[:, :, None, None, None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class PixelwiseSelfAttentionFusion(nn.Module):
    """Per-pixel (L, L) scaled-dot self-attention over the agents, keeping
    every agent's row: x (B, L, C, H, W) -> (B, L, C, H, W)."""

    def forward(self, x, agent_mask):
        c = x.shape[2]
        scores = torch.einsum("bkchw,blchw->bklhw", x, x) / math.sqrt(c)
        attn = masked_softmax(scores, agent_mask[:, None, :, None, None], dim=2)
        return torch.einsum("bklhw,blchw->bkchw", attn, x)
