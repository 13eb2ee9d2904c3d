"""CoBEVT fused-axial fusion (counterpart of airv2x_tpu/models/fusion/cobevt.py):
joint attention over (agent, window row, window column) tokens with a 3-D
relative position bias, first on contiguous ws x ws windows, then on a
strided ws x ws grid, each pass followed by a feed-forward, all pre-norm
residual; then a plain mean over the agent axis (padded slots included, as
the reference's ``Reduce('b m d h w -> b d h w', 'mean')``), LayerNorm and a
Linear.

The encoder runs channels-last, x (B, L, H, W, C), so that every Linear
acts on the last axis; ``SwapFusionEncoder`` permutes from the port's NCHW
per-agent layout at its entry and back at its exit. Every Linear computes in
its weight's dtype, every LayerNorm is V2X-ViT's flax twin (f32 statistics,
eps 1e-6), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.common import NEG_INF
from airv2x_tpu_torch.models.fusion.v2xvit import LayerNorm, _dense


def _relative_position_index(agent_size: int, ws: int) -> np.ndarray:
    """(N, N) index into the (2L - 1)(2ws - 1)(2ws - 1) bias table, N = L ws
    ws, tokens ordered (agent, row, column)."""
    coords = np.stack(
        np.meshgrid(np.arange(agent_size), np.arange(ws), np.arange(ws),
                    indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += agent_size - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 2] += ws - 1
    rel[:, :, 0] *= (2 * ws - 1) * (2 * ws - 1)
    rel[:, :, 1] *= 2 * ws - 1
    return rel.sum(-1)


class WindowedAgentAttention(nn.Module):
    """Joint attention over the L x ws x ws tokens of each window location,
    with the learned ``relative_position_bias`` table ((2L - 1)(2ws - 1)^2,
    heads) indexed by ``_relative_position_index``."""

    FLAX_NAMES = {"to_qkv": "Dense_0", "to_out": "Dense_1"}

    def __init__(self, dim: int, dim_head: int, agent_size: int,
                 window_size: int):
        super().__init__()
        self.heads, self.dim_head = dim // dim_head, dim_head
        ws = window_size
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        table = (2 * agent_size - 1) * (2 * ws - 1) * (2 * ws - 1)
        self.relative_position_bias = nn.Parameter(torch.empty(table, self.heads))
        self.register_buffer(
            "rel_index",
            torch.from_numpy(_relative_position_index(agent_size, ws)),
            persistent=False)
        self.to_out = nn.Linear(dim, dim, bias=False)
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, g: torch.Generator | None = None) -> None:
        """flax's normal(0.02) bias table, drawn from ``g``."""
        p = self.relative_position_bias
        dev = g.device if g is not None else "cpu"
        t = torch.empty(p.shape, dtype=torch.float32, device=dev)
        p.copy_(t.normal_(0.0, 0.02, generator=g))

    def forward(self, x, mask=None):
        """x (B, L, nx, ny, w1, w2, C); mask (B, nx, ny, w1, w2, L), > 0
        where an agent counts, or None -> the same shape."""
        b, l, nx, ny, w1, w2, d = x.shape
        heads, dh = self.heads, self.dim_head
        n = l * w1 * w2
        tokens = x.permute(0, 2, 3, 1, 4, 5, 6).reshape(b * nx * ny, n, d)
        q, k, v = (t.reshape(-1, n, heads, dh).transpose(1, 2)
                   for t in _dense(self.to_qkv, tokens).chunk(3, dim=-1))
        sim = torch.einsum("bhic,bhjc->bhij", q * (dh ** -0.5), k)
        bias = self.relative_position_bias[self.rel_index]  # (N, N, heads)
        sim = sim + bias.permute(2, 0, 1).to(sim.dtype)
        if mask is not None:
            m = mask.permute(0, 1, 2, 5, 3, 4).reshape(b * nx * ny, 1, 1, n)
            sim = sim.masked_fill(~(m > 0), NEG_INF)
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bhij,bhjc->bhic", attn, v)
        out = out.transpose(1, 2).reshape(b * nx * ny, n, heads * dh)
        out = _dense(self.to_out, out)
        return out.reshape(b, nx, ny, l, w1, w2, -1).permute(0, 3, 1, 2, 4, 5, 6)


class _FeedForward(nn.Module):
    """Linear -> tanh GELU (flax ``nn.gelu``'s default) -> Linear."""

    FLAX_NAMES = {"up": "Dense_0", "down": "Dense_1"}

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.up = nn.Linear(dim, hidden)
        self.down = nn.Linear(hidden, dim)

    def forward(self, x):
        return _dense(self.down, F.gelu(_dense(self.up, x), approximate="tanh"))


class SwapFusionBlock(nn.Module):
    """Window attention -> feed-forward -> grid attention -> feed-forward,
    each pre-norm residual. The window pass splits (H, W) into contiguous
    (nx, ws, ny, ws) blocks, the grid pass into strided (ws, nx, ws, ny)
    ones."""

    FLAX_NAMES = {"attn": "WindowedAgentAttention", "norms": "LayerNorm",
                  "ffn": "_FeedForward"}

    def __init__(self, input_dim: int, mlp_dim: int, dim_head: int,
                 window_size: int, agent_size: int):
        super().__init__()
        self.ws = window_size
        # flax's creation order: attention, its LayerNorm, feed-forward, its
        # LayerNorm, per pass (window, grid)
        self.attn = nn.ModuleList(
            WindowedAgentAttention(input_dim, dim_head, agent_size, window_size)
            for _ in range(2))
        self.norms = nn.ModuleList(LayerNorm(input_dim) for _ in range(4))
        self.ffn = nn.ModuleList(_FeedForward(input_dim, mlp_dim)
                                 for _ in range(2))

    def _split(self, t, grid: bool):
        """(B, L, H, W, C) -> (B, L, nx, ny, ws, ws, C)."""
        b, l, h, w, c = t.shape
        ws = self.ws
        nx, ny = h // ws, w // ws
        if not grid:
            return t.reshape(b, l, nx, ws, ny, ws, c).permute(0, 1, 2, 4, 3, 5, 6)
        return t.reshape(b, l, ws, nx, ws, ny, c).permute(0, 1, 3, 5, 2, 4, 6)

    @staticmethod
    def _merge(t, grid: bool):
        b, l, nx, ny, w1, w2, c = t.shape
        if not grid:
            t = t.permute(0, 1, 2, 4, 3, 5, 6)
        else:
            t = t.permute(0, 1, 4, 2, 5, 3, 6)
        return t.reshape(b, l, nx * w1, ny * w2, c)

    def _mask_split(self, m, grid: bool):
        """(B, H, W, L) -> (B, nx, ny, ws, ws, L), as the features split."""
        if m is None:
            return None
        b, h, w, l = m.shape
        ws = self.ws
        nx, ny = h // ws, w // ws
        if not grid:
            return m.reshape(b, nx, ws, ny, ws, l).permute(0, 1, 3, 2, 4, 5)
        return m.reshape(b, ws, nx, ws, ny, l).permute(0, 2, 4, 1, 3, 5)

    def forward(self, x, mask=None):
        """x (B, L, H, W, C); mask (B, H, W, L) or None."""
        for p, grid in enumerate((False, True)):
            xw = self._split(x, grid)
            mw = self._mask_split(mask, grid)
            attn, ffn = self.attn[p], self.ffn[p]
            xw = xw + attn(self.norms[2 * p](xw, attn.to_qkv.weight.dtype), mw)
            xw = xw + ffn(self.norms[2 * p + 1](xw, ffn.up.weight.dtype))
            x = self._merge(xw, grid)
        return x


class SwapFusionEncoder(nn.Module):
    """``depth`` SwapFusionBlocks, then the mean over all L slots (padded
    ones included), LayerNorm and a Linear: (B, L, C, H, W) -> (B, C, H, W).
    With ``mask: true`` the agent mask hides absent agents as keys."""

    FLAX_NAMES = {"blocks": "SwapFusionBlock", "norm": "LayerNorm_0",
                  "out": "Dense_0"}

    def __init__(self, args: dict):
        super().__init__()
        dim = int(args["input_dim"])
        self.use_mask = bool(args.get("mask"))
        self.blocks = nn.ModuleList(
            SwapFusionBlock(dim, int(args["mlp_dim"]), int(args["dim_head"]),
                            int(args["window_size"]), int(args["agent_size"]))
            for _ in range(int(args["depth"])))
        self.norm = LayerNorm(dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x, agent_mask):
        x = x.permute(0, 1, 3, 4, 2)
        b, l, h, w, _ = x.shape
        mask = (agent_mask[:, None, None, :].expand(b, h, w, l).to(x.dtype)
                if self.use_mask else None)
        for block in self.blocks:
            x = block(x, mask)
        pooled = x.mean(dim=1)
        out = _dense(self.out, self.norm(pooled, self.out.weight.dtype))
        return out.permute(0, 3, 1, 2)
