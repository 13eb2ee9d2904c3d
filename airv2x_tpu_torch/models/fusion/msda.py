"""Multi-scale deformable attention (counterpart of
airv2x_tpu/models/fusion/msda.py: ``sample_bilinear_zeros``,
``MSDeformAttn``, ``FeedForwardGELU``, ``DeformTransformer`` and
``DeformableQueryRefine``), channels-last.

Each query bilinearly samples every level's value map at ``n_points``
learned offsets per head around its reference point, as
``grid_sample(align_corners=False)`` with zero padding samples at
``loc * size - 0.5``, and blends the samples with weights softmaxed over
levels x points per head. The samples are four flat gathers (one per
bilinear corner) from the (level, y, x, head) rows of the projected values.
SCOPE's levels are the agent slots of one BEV scale.

Dtypes follow the JAX package's: each Linear computes in its weight's
dtype (the compute dtype after ``cast_weights_``), the sampling locations
and bilinear weights are f32, so the sampled sums are f32 until the output
projection; LayerNorm is flax's (``fusion/v2xvit.py:LayerNorm``).
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.v2xvit import LayerNorm, _dense
from airv2x_tpu_torch.ops.warp import device_scalar, grid_sample_bilinear


def sample_bilinear_zeros(img, x, y):
    """Bilinear sample of ``img`` (H, W, C) at float pixel coordinates
    ``x`` / ``y`` of any (equal) shape -> x.shape + (C,); taps outside the
    image contribute zero."""
    flat = grid_sample_bilinear(img, x.reshape(1, -1), y.reshape(1, -1))
    return flat.reshape(x.shape + (img.shape[-1],))


class MSDeformAttn(nn.Module):
    """Query-conditioned sampling offsets and attention weights over
    (levels x points) per head; values projected per head and bilinearly
    sampled from each level's map."""

    def __init__(self, d_model: int, d_head: int = 64, n_levels: int = 5,
                 n_heads: int = 8, n_points: int = 4):
        super().__init__()
        self.n_levels, self.n_heads = n_levels, n_heads
        self.n_points, self.d_head = n_points, d_head
        self.value_proj = nn.Linear(d_model, d_head * n_heads)
        self.sampling_offsets = nn.Linear(d_model,
                                          n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_head * n_heads, d_model)

    def forward(self, query, reference_points, src_maps):
        """query (B, Lq, d_model); reference_points (B, Lq, n_levels, 2) in
        [0, 1], (x, y); src_maps (B, levels, H, W, d_model) ->
        (B, Lq, d_model)."""
        b, lq = query.shape[:2]
        lv, h, w = src_maps.shape[1:4]
        heads, pts, dh = self.n_heads, self.n_points, self.d_head

        # (B, levels * H * W * heads, dh): row ((lv * H + y) * W + x) * heads + head
        value = _dense(self.value_proj, src_maps).reshape(b, lv * h * w * heads, dh)
        offsets = _dense(self.sampling_offsets, query).reshape(
            b, lq, heads, self.n_levels, pts, 2)
        attn = torch.softmax(_dense(self.attention_weights, query).reshape(
            b, lq, heads, self.n_levels * pts), dim=-1).reshape(
            b, lq, heads, self.n_levels, pts)

        normalizer = torch.stack([device_scalar(w, query), device_scalar(h, query)])
        loc = (reference_points[:, :, None, :, None, :].float()
               + offsets[:, :, :, :lv] / normalizer)  # (B, Lq, heads, lv, pts, 2)
        px = loc[..., 0] * w - 0.5
        py = loc[..., 1] * h - 0.5

        x0, y0 = torch.floor(px), torch.floor(py)
        tx, ty = (px - x0)[..., None], (py - y0)[..., None]
        x0i, y0i = x0.long(), y0.long()
        dev = value.device
        lv_idx = torch.arange(lv, device=dev)[None, None, None, :, None]
        head_idx = torch.arange(heads, device=dev)[None, None, :, None, None]
        batch_idx = torch.arange(b, device=dev)[:, None, None, None, None]

        def tap(yi, xi):
            inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            rows = ((lv_idx * h + yi.clamp(0, h - 1)) * w
                    + xi.clamp(0, w - 1)) * heads + head_idx
            return value[batch_idx, rows] * inside[..., None].to(value.dtype)

        top = tap(y0i, x0i) * (1 - tx) + tap(y0i, x0i + 1) * tx
        bot = tap(y0i + 1, x0i) * (1 - tx) + tap(y0i + 1, x0i + 1) * tx
        sampled = top * (1 - ty) + bot * ty  # (B, Lq, heads, lv, pts, dh)
        out = (sampled * attn[..., None]).sum(dim=(3, 4))
        return _dense(self.output_proj, out.reshape(b, lq, heads * dh))


class FeedForwardGELU(nn.Module):
    """Linear -> GELU (tanh form) -> Linear."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        x = torch.nn.functional.gelu(_dense(self.fc1, x), approximate="tanh")
        return _dense(self.fc2, x)


class DeformTransformer(nn.Module):
    """``depth`` x [deformable cross-attention with one LayerNorm shared by
    the queries and the source maps, + residual; pre-norm feed-forward +
    residual], after a Linear position embedding of the queries'
    normalized centres. The submodules carry the flax scope names
    (``layer<i>_ca_norm``, ``layer<i>_cross_attn``, ``layer<i>_ff_norm``,
    ``layer<i>_ff``)."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8, levels: int = 5,
                 dim_head: int = 64, mlp_dim: int = 256, n_points: int = 9):
        super().__init__()
        self.depth, self.levels = depth, levels
        self.pos_embedding = nn.Linear(2, dim)
        for i in range(depth):
            self.add_module(f"layer{i}_ca_norm", LayerNorm(dim))
            self.add_module(f"layer{i}_cross_attn", MSDeformAttn(
                dim, dim_head, levels, heads, n_points))
            self.add_module(f"layer{i}_ff_norm", LayerNorm(dim))
            self.add_module(f"layer{i}_ff", FeedForwardGELU(dim, mlp_dim))

    def forward(self, x, src_maps, center_pos):
        """x (B, K, dim) queries; src_maps (B, levels, H, W, dim);
        center_pos (B, K, 2) normalized (x, y)."""
        dt = self.pos_embedding.weight.dtype
        pos = _dense(self.pos_embedding, center_pos)
        ref = center_pos[:, :, None, :].expand(-1, -1, self.levels, -1)
        for i in range(self.depth):
            norm = getattr(self, f"layer{i}_ca_norm")
            att = getattr(self, f"layer{i}_cross_attn")(
                norm(x, dt) + pos, ref, norm(src_maps, dt))
            x = att + x
            xn = getattr(self, f"layer{i}_ff_norm")(x, dt)
            x = getattr(self, f"layer{i}_ff")(xn) + x
        return x


class DeformableQueryRefine(nn.Module):
    """The ``num_queries`` most confident ego BEV cells (summed over the
    agent slots) become queries; each attends deformably over every slot's
    map (slots = levels), and the refined features are written back into
    the ego map at their cells.

    The query order is a stable descending sort of the scores: tied scores
    keep the lower cell index first, as ``jax.lax.top_k`` takes them."""

    def __init__(self, channels: int, n_points: int, num_queries: int = 500,
                 max_cav: int = 5):
        super().__init__()
        self.num_queries = num_queries
        self.transformer = DeformTransformer(
            dim=channels, depth=1, heads=8, levels=max_cav, dim_head=64,
            mlp_dim=256, n_points=n_points)

    def forward(self, x, psm):
        """x (B, L, H, W, C) slot maps (ego first, zero-padded); psm
        (B, L, H, W) confidence maps -> (B, H, W, C)."""
        b, l, h, w, c = x.shape
        k = min(self.num_queries, h * w)
        scores = psm.sum(dim=1).reshape(b, h * w)
        order = torch.sort(scores, dim=1, descending=True, stable=True)[1][:, :k]
        ego = x[:, 0].reshape(b, h * w, c)
        ct_feat = torch.gather(ego, 1, order[..., None].expand(-1, -1, c))
        rows = torch.div(order, w, rounding_mode="floor")
        y_coor = rows.float() / device_scalar(h, x)
        x_coor = (order % w).float() / device_scalar(w, x)
        center_pos = torch.stack([x_coor, y_coor], dim=-1)
        refined = self.transformer(ct_feat, x, center_pos)
        out = ego.scatter(1, order[..., None].expand(-1, -1, c),
                          refined.to(ego.dtype))
        return out.reshape(b, h, w, c)
