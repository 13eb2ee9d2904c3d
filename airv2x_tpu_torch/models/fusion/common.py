"""Fusion building blocks over the dense agent axis (counterpart of
airv2x_tpu/models/fusion/common.py: ``masked_softmax`` and
``ego_agent_attention``), NCHW per agent."""

from __future__ import annotations

import math

import torch

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
