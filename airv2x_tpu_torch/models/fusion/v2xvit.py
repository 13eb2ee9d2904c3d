"""V2X-ViT fusion (counterpart of airv2x_tpu/models/fusion/v2xvit.py): the
STTF warp into the ego frame, relative temporal encoding (RTE), typed
(vehicle / infrastructure) per-pixel agent attention (HGT) and a pyramid of
windowed self-attentions fused by split attention.

The transformer runs channels-last, x (B, L, H, W, C), so that every Linear
acts on the last axis; ``V2XTransformer`` permutes from and to the port's
NCHW per-agent layout once, at its entry and exit.

Dtypes follow the JAX package's: every Linear computes in its weight's
dtype (the compute dtype after ``cast_weights_``), RTE's Linear in f32 (its
flax Dense has no dtype), every LayerNorm takes f32 statistics by
E[x^2] - E[x]^2 (flax's fast variance, eps 1e-6) with f32 parameters and
returns the compute dtype. The STTF warp samples on an f32 grid, so from
there on the residual stream is f32 even under a bf16 compute dtype, as it
is in JAX.

HGT attention uses the JAX package's factored form: with two types and the
relation index rel(i, j) = 2 t_i + t_j, the relation-weighted scores and
messages are sums over t_j of agent-indexed (c, c) products, so the
reference's (B, M, H, W, L, L, c) relation tensor is never formed.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.common import NEG_INF
from airv2x_tpu_torch.ops.warp import rotated_roi_mask, warp_bev_features

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """A Linear in its weight's dtype (a flax Dense with ``dtype``)."""
    return lin(x.to(lin.weight.dtype))


def _masked_scores(scores, keep):
    """Scores where ``keep``, else NEG_INF, then a plain softmax over the
    last axis: a row with every column masked becomes uniform, as in JAX
    (``fusion.common.masked_softmax`` would zero it)."""
    return torch.softmax(scores.masked_fill(~keep, NEG_INF), dim=-1)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` over the last axis: f32 statistics with the
    variance E[x^2] - E[x]^2 clamped at 0, eps 1e-6, the f32 scale folded
    into the inverse deviation, the result cast to ``dtype`` (the flax
    module's ``dtype``). ``cast_weights_`` keeps its parameters f32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LN_EPS)

    def forward(self, x, dtype):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(dtype)


class STTF(nn.Module):
    """Spatio-temporal transform: warp the non-ego agents' BEV features into
    the ego frame by their ``pairwise_t``."""

    def __init__(self, discrete_ratio: float, downsample_rate: float):
        super().__init__()
        self.discrete_ratio = float(discrete_ratio)
        self.downsample_rate = float(downsample_rate)

    def forward(self, x, pairwise_t):
        return warp_bev_features(x, pairwise_t, self.discrete_ratio,
                                 self.downsample_rate)


def rte_table(dim: int, max_len: int) -> np.ndarray:
    """The (max_len, dim) sinusoidal table, built in numpy f32 as the JAX
    package builds it."""
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * -(math.log(10000.0) / dim))
    table = np.zeros((max_len, dim), np.float32)
    table[:, 0::2] = np.sin(pos * div) / math.sqrt(dim)
    table[:, 1::2] = np.cos(pos * div) / math.sqrt(dim)
    return table


class RTE(nn.Module):
    """Relative temporal encoding: the sinusoidal row of each agent's delay
    (``clip(dts * ratio, 0, max_len - 1)``) through an f32 Linear, added to
    every pixel of the agent."""

    KEEP_F32 = True  # cast_weights_ leaves it f32: its flax Dense has no dtype

    def __init__(self, dim: int, rte_ratio: int = 2, max_len: int = 100):
        super().__init__()
        self.rte_ratio = int(rte_ratio)
        self.max_len = int(max_len)
        self.register_buffer("table", torch.from_numpy(rte_table(dim, max_len)),
                             persistent=False)
        self.lin = nn.Linear(dim, dim)

    def forward(self, x, dts):
        """x (B, L, H, W, C); dts (B, L) integer delays."""
        idx = (dts * self.rte_ratio).clamp(0, self.max_len - 1).long()
        emb = self.lin(self.table[idx].to(self.lin.weight.dtype))
        return x + emb[:, :, None, None, :].to(x.dtype)


def _split_heads(t, heads: int):
    b, l, h, w, d = t.shape
    return t.reshape(b, l, h, w, heads, d // heads)


class CavAttention(nn.Module):
    """Per-pixel scaled-dot attention across the agents."""

    FLAX_NAMES = {"to_qkv": "Dense_0", "to_out": "Dense_1"}

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    @property
    def compute_dtype(self):
        return self.to_qkv.weight.dtype

    def forward(self, x, mask, types=None):
        """x (B, L, H, W, C); mask (B, H, W, L), > 0 where an agent counts."""
        q, k, v = (_split_heads(t, self.heads)
                   for t in _dense(self.to_qkv, x).chunk(3, dim=-1))
        scores = torch.einsum("bihwmc,bjhwmc->bhwmij", q, k) * (
            self.dim_head ** -0.5)
        attn = _masked_scores(scores, mask[:, :, :, None, None, :] > 0)
        out = torch.einsum("bhwmij,bjhwmc->bihwmc", attn, v)
        return _dense(self.to_out, out.flatten(-2))


def relation_init_limit(shape) -> float:
    """flax ``xavier_uniform``'s bound for a (..., c_in, c_out) tensor: the
    leading axes count as receptive field, sqrt(6 / (fan_in + fan_out))."""
    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    return math.sqrt(6.0 / (fan_in + fan_out))


class HGTCavAttention(nn.Module):
    """Heterogeneous agent attention: per-type q / k / v / output Linears,
    selected per agent by its type (both types are computed for every agent
    and one is kept, as in JAX), and the relation tensors ``relation_att`` /
    ``relation_msg`` (T * T, heads, c, c), applied as ``q @ W[2 t_i + t_j]``
    with no transpose."""

    def __init__(self, dim: int, heads: int, dim_head: int, num_types: int = 2):
        super().__init__()
        self.heads, self.dim_head, self.num_types = heads, dim_head, num_types
        inner = heads * dim_head
        for name, (i, o) in (("q", (dim, inner)), ("k", (dim, inner)),
                             ("v", (dim, inner)), ("a", (inner, dim))):
            setattr(self, name, nn.ModuleList(
                nn.Linear(i, o) for _ in range(num_types)))
        shape = (num_types * num_types, heads, dim_head, dim_head)
        self.relation_att = nn.Parameter(torch.empty(shape))
        self.relation_msg = nn.Parameter(torch.empty(shape))
        self.flax_init_()

    @torch.no_grad()
    def flax_init_(self, g: torch.Generator | None = None) -> None:
        """flax's ``xavier_uniform`` relation tensors, drawn from ``g``."""
        dev = g.device if g is not None else "cpu"
        for p in (self.relation_att, self.relation_msg):
            lim = relation_init_limit(p.shape)
            t = torch.empty(p.shape, dtype=torch.float32, device=dev)
            p.copy_(t.uniform_(-lim, lim, generator=g))

    @property
    def compute_dtype(self):
        return self.q[0].weight.dtype

    @staticmethod
    def _typed(lins, x, types):
        """Every type's Linear on every agent, then each agent's own type's
        output: (B, L, ..., C) -> (B, L, ..., C')."""
        b, l = types.shape
        bi = torch.arange(b, device=types.device)[:, None]
        li = torch.arange(l, device=types.device)[None, :]
        return torch.stack([_dense(lin, x) for lin in lins])[types.long(), bi, li]

    def forward(self, x, mask, types):
        """x (B, L, H, W, C); mask (B, H, W, L), > 0 where an agent counts;
        types (B, L) in [0, num_types)."""
        nt = self.num_types
        q, k, v = (_split_heads(self._typed(lins, x, types), self.heads)
                   for lins in (self.q, self.k, self.v))
        dt = q.dtype
        w_att = self.relation_att.to(dt)
        w_msg = self.relation_msg.to(dt)
        t = types.long()
        onehot = F.one_hot(t, nt).to(dt)  # (B, L, T)
        scale = self.dim_head ** -0.5
        scores = 0
        for tj in range(nt):
            w_i = w_att[t * nt + tj]  # (B, L, M, c, c): W_{2 t_i + tj}
            qw = torch.einsum("bihwmp,bimpq->bihwmq", q, w_i)
            s = torch.einsum("bihwmq,bjhwmq->bhwmij", qw, k) * scale
            # only the columns j of type tj count
            scores = scores + s * onehot[:, None, None, None, None, :, tj]
        attn = _masked_scores(scores, mask[:, :, :, None, None, :] > 0)
        out = 0
        for tj in range(nt):
            vj = v * onehot[:, :, None, None, None, tj, None]
            mix = torch.einsum("bhwmij,bjhwmc->bihwmc", attn, vj)
            out = out + torch.einsum("bihwmp,bimpc->bihwmc", mix,
                                     w_msg[t * nt + tj])
        return self._typed(self.a, out.flatten(-2), types)


class BaseWindowAttention(nn.Module):
    """Self-attention inside non-overlapping ws x ws windows of each agent's
    map, with a learned relative position bias ``rel[i, j] = idx[j] -
    idx[i] + ws - 1`` (the JAX package's sign, opposite to Swin's usual;
    idx enumerates (x, y) with x outer), or an absolute (ws^2, ws^2) one."""

    FLAX_NAMES = {"to_qkv": "Dense_0", "to_out": "Dense_1"}

    def __init__(self, dim: int, heads: int, dim_head: int, window_size: int,
                 relative_pos_embedding: bool = True):
        super().__init__()
        self.heads, self.dim_head, self.ws = heads, dim_head, window_size
        self.relative = relative_pos_embedding
        inner = heads * dim_head
        ws = window_size
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        if relative_pos_embedding:
            idx = np.array([[xx, yy] for xx in range(ws) for yy in range(ws)])
            rel = idx[None, :, :] - idx[:, None, :] + ws - 1
            self.register_buffer("rel_a", torch.from_numpy(rel[..., 0]),
                                 persistent=False)
            self.register_buffer("rel_b", torch.from_numpy(rel[..., 1]),
                                 persistent=False)
            self.pos_embedding = nn.Parameter(torch.randn(2 * ws - 1, 2 * ws - 1))
        else:
            self.pos_embedding = nn.Parameter(torch.randn(ws * ws, ws * ws))
        self.to_out = nn.Linear(inner, dim)

    @torch.no_grad()
    def flax_init_(self, g: torch.Generator | None = None) -> None:
        """flax's standard normal ``pos_embedding``, drawn from ``g``."""
        dev = g.device if g is not None else "cpu"
        t = torch.empty(self.pos_embedding.shape, dtype=torch.float32, device=dev)
        self.pos_embedding.copy_(t.normal_(0.0, 1.0, generator=g))

    def forward(self, x):
        """x (B, L, H, W, C), H and W multiples of the window size."""
        b, l, h, w, _ = x.shape
        ws, heads, dh = self.ws, self.heads, self.dim_head
        nh, nw = h // ws, w // ws

        def to_windows(t):  # channel = head * dh + c
            t = t.reshape(b, l, nh, ws, nw, ws, heads, dh)
            return t.permute(0, 1, 6, 2, 4, 3, 5, 7).reshape(
                b, l, heads, nh * nw, ws * ws, dh)

        q, k, v = (to_windows(t)
                   for t in _dense(self.to_qkv, x).chunk(3, dim=-1))
        dots = torch.matmul(q, k.transpose(-1, -2)) * (dh ** -0.5)
        bias = (self.pos_embedding[self.rel_a, self.rel_b] if self.relative
                else self.pos_embedding)
        attn = torch.softmax(dots + bias.to(dots.dtype), dim=-1)
        out = torch.matmul(attn, v).reshape(b, l, heads, nh, nw, ws, ws, dh)
        out = out.permute(0, 1, 3, 5, 4, 6, 2, 7).reshape(b, l, h, w, heads * dh)
        return _dense(self.to_out, out)


class SplitAttn(nn.Module):
    """Radix-3 split attention over the three window branches: a global
    average over H and W, Linear -> LayerNorm -> ReLU -> Linear to 3 C
    logits, a softmax over the radix of their (3, C) reshape, and the
    branches' weighted sum."""

    FLAX_NAMES = {"fc1": "Dense_0", "norm": "LayerNorm_0", "fc2": "Dense_1"}

    def __init__(self, input_dim: int):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = nn.Linear(input_dim, input_dim, bias=False)
        self.norm = LayerNorm(input_dim)
        self.fc2 = nn.Linear(input_dim, 3 * input_dim, bias=False)

    def forward(self, windows: Sequence[torch.Tensor]):
        if len(windows) != 3:
            raise ValueError(f"split attention fuses 3 branches, got {len(windows)}")
        sw, mw, bw = windows
        c = self.input_dim
        gap = (sw + mw + bw).mean((2, 3), keepdim=True)  # (B, L, 1, 1, C)
        gap = _dense(self.fc1, gap)
        gap = F.relu(self.norm(gap, self.fc1.weight.dtype))
        attn = _dense(self.fc2, gap)
        b, l = attn.shape[:2]
        attn = torch.softmax(attn.reshape(b, l, 1, 3, c), dim=3).reshape(
            b, l, 1, 1, 3 * c)
        return (sw * attn[..., :c] + mw * attn[..., c:2 * c]
                + bw * attn[..., 2 * c:])


class PyramidWindowAttention(nn.Module):
    """One BaseWindowAttention per window size, fused by SplitAttn or, with
    ``fuse_method='naive'``, by their mean."""

    FLAX_NAMES = {"windows": "BaseWindowAttention", "split_attn": "SplitAttn_0"}

    def __init__(self, dim: int, heads: Sequence[int], dim_heads: Sequence[int],
                 window_size: Sequence[int], relative_pos_embedding: bool = True,
                 fuse_method: str = "split_attn"):
        super().__init__()
        if fuse_method not in ("naive", "split_attn"):
            raise ValueError(f"unknown fuse_method {fuse_method!r}")
        self.windows = nn.ModuleList(
            BaseWindowAttention(dim, h, dh, ws, relative_pos_embedding)
            for h, dh, ws in zip(heads, dim_heads, window_size))
        self.split_attn = SplitAttn(dim) if fuse_method == "split_attn" else None

    def forward(self, x):
        outs = [win(x) for win in self.windows]
        if self.split_attn is None:
            return sum(outs) / len(outs)
        return self.split_attn(outs)


class V2XFusionBlock(nn.Module):
    """``num_blocks`` x (LayerNorm -> agent attention, residual; LayerNorm ->
    pyramid window attention, residual)."""

    def __init__(self, num_blocks: int, cav_att_config: dict,
                 pwindow_config: dict):
        super().__init__()
        cav, pw = cav_att_config, pwindow_config
        att_cls = HGTCavAttention if cav.get("use_hetero") else CavAttention
        self.FLAX_NAMES = {"att": att_cls.__name__, "norms": "LayerNorm",
                           "pwin": "PyramidWindowAttention"}
        self.att = nn.ModuleList(
            att_cls(cav["dim"], cav["heads"], cav["dim_head"])
            for _ in range(num_blocks))
        self.norms = nn.ModuleList(LayerNorm(cav["dim"])
                                   for _ in range(2 * num_blocks))
        self.pwin = nn.ModuleList(
            PyramidWindowAttention(
                pw["dim"], pw["heads"], pw["dim_head"], pw["window_size"],
                pw["relative_pos_embedding"], pw["fusion_method"])
            for _ in range(num_blocks))

    def forward(self, x, mask, types):
        for i, (att, pwin) in enumerate(zip(self.att, self.pwin)):
            dt = att.compute_dtype
            x = att(self.norms[2 * i](x, dt), mask, types) + x
            x = pwin(self.norms[2 * i + 1](x, dt)) + x
        return x


class V2XTEncoder(nn.Module):
    """RTE (``cav_att_config.use_RTE``) -> STTF -> the ROI and agent mask ->
    ``depth`` x (V2XFusionBlock; LayerNorm -> Linear -> tanh GELU -> Linear,
    residual). Types and delays come from ``prior_encoding`` (B, L, 3):
    ``[..., 1]`` truncated to an integer is the delay, ``[..., 2]`` the
    infrastructure flag (so a drone is type 0, with the vehicles)."""

    def __init__(self, args: dict):
        super().__init__()
        cav = args["cav_att_config"]
        pw = args["pwindow_att_config"]
        feed = args["feed_forward"]
        sttf = args["sttf"]
        self.discrete_ratio = float(sttf["voxel_size"][0])
        self.downsample_rate = float(sttf["downsample_rate"])
        self.use_roi_mask = bool(args.get("use_roi_mask"))
        depth = int(args["depth"])
        self.FLAX_NAMES = {"rte": "RTE_0", "blocks": "V2XFusionBlock",
                           "norms": "LayerNorm", "ffn": "Dense"}
        self.rte = (RTE(cav["dim"], cav.get("RTE_ratio", 2))
                    if cav.get("use_RTE") else None)
        self.sttf = STTF(self.discrete_ratio, self.downsample_rate)
        self.blocks = nn.ModuleList(
            V2XFusionBlock(int(args["num_blocks"]), cav, pw)
            for _ in range(depth))
        self.norms = nn.ModuleList(LayerNorm(cav["dim"]) for _ in range(depth))
        # flax's Dense_{2d} (up) and Dense_{2d+1} (down) of depth d
        self.ffn = nn.ModuleList(
            lin for _ in range(depth)
            for lin in (nn.Linear(cav["dim"], feed["mlp_dim"]),
                        nn.Linear(feed["mlp_dim"], cav["dim"])))

    def forward(self, x, agent_mask, pairwise_t, prior_encoding):
        """x (B, L, H, W, C); agent_mask (B, L) bool; pairwise_t (B, L, 4, 4);
        prior_encoding (B, L, 3) -> (B, L, H, W, C)."""
        dts = prior_encoding[..., 1].to(torch.int32)
        types = prior_encoding[..., 2].to(torch.int32)
        if self.rte is not None:
            x = self.rte(x, dts)
        x = self.sttf(x, pairwise_t)
        b, l, h, w = x.shape[:4]
        if self.use_roi_mask:
            roi = rotated_roi_mask((h, w), pairwise_t, self.discrete_ratio,
                                   self.downsample_rate)
            mask = (roi & agent_mask[:, :, None, None]).permute(0, 2, 3, 1)
        else:
            mask = agent_mask[:, None, None, :].expand(b, h, w, l)
        for d, block in enumerate(self.blocks):
            x = block(x, mask, types)
            up, down = self.ffn[2 * d], self.ffn[2 * d + 1]
            y = _dense(up, self.norms[d](x, up.weight.dtype))
            x = _dense(down, F.gelu(y, approximate="tanh")) + x
        return x


class V2XTransformer(nn.Module):
    """The ``transformer`` config block: V2XTEncoder on the channels-last
    agent maps, returning the ego slot."""

    FLAX_NAMES = {"encoder": "V2XTEncoder_0"}

    def __init__(self, args: dict):
        super().__init__()
        self.encoder = V2XTEncoder(args["encoder"])

    def forward(self, x, agent_mask, pairwise_t, prior_encoding):
        """x (B, L, C, H, W) -> the fused ego map (B, C, H, W)."""
        x = x.permute(0, 1, 3, 4, 2).contiguous()
        out = self.encoder(x, agent_mask, pairwise_t, prior_encoding)
        return out[:, 0].permute(0, 3, 1, 2)
