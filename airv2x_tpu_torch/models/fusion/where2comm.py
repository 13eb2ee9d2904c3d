"""Where2comm fusion (counterpart of airv2x_tpu/models/fusion/where2comm.py).

Communication: sigmoid confidence (no gradient) -> max over anchor/class
channels -> fixed 5x5 *unnormalised* gaussian (SAME padding) -> in eval
``conf > threshold``; in training the reference's random top-K proxy: per
sample a keep fraction u, and each agent keeps its floor(u * H * W) most
confident pixels. The rate is measured before the ego row is forced on.
Multi-scale fusion reruns the shared backbone stages on the raw BEV
features, gates stage 0 with the mask and fuses agents with ego-query
attention at every scale; single-scale fusion (the flat OPV2V model) gates
the agents' 2-D maps with the mask and fuses them with ego-query attention
once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.fusion.common import ego_agent_attention


def _gaussian_kernel(k_size: int, sigma: float) -> np.ndarray:
    half = k_size // 2
    x, y = np.mgrid[-half : k_size - half, -half : k_size - half]
    g = 1.0 / (2 * np.pi * sigma) * np.exp(-(x**2 + y**2) / (2 * sigma**2))
    return g.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gaussian_weight(k_size: int, sigma: float, device, dtype):
    # a normal tensor even when first made under inference mode: the cached
    # kernel may later be saved for a backward (SCOPE's confidence is not
    # detached)
    with torch.inference_mode(False):
        g = torch.from_numpy(_gaussian_kernel(k_size, sigma))
        return g.to(device=device, dtype=dtype)[None, None]


def gaussian_smooth(conf: torch.Tensor, k_size: int, sigma: float):
    """Fixed gaussian blur of (..., H, W) confidence maps, SAME padding."""
    if k_size % 2 != 1:
        raise ValueError(f"k_size must be odd, got {k_size}")
    h, w = conf.shape[-2:]
    kern = _gaussian_weight(k_size, float(sigma), conf.device, conf.dtype)
    out = F.conv2d(conf.reshape(-1, 1, h, w), kern, padding=k_size // 2)
    return out.reshape(conf.shape)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) f32 weights of a half-pixel bilinear resize along one
    axis, computed as ``jax.image.resize`` computes them: the triangle
    kernel, widened by the shrink factor when the axis shrinks (the
    antialias), each column normalised to sum 1. The sample positions
    ``(i + 0.5) * inv - 0.5`` round once, as the fused multiply-add that
    XLA compiles there (the f64 product of two f32 values is exact)."""
    inv = 1.0 / (n_out / n_in)
    centre = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    sample = (centre.double() * float(np.float32(inv)) - 0.5).float()
    src = torch.arange(n_in, dtype=torch.float32, device=device)
    x = (sample[None, :] - src[:, None]).abs() / max(inv, 1.0)
    w = torch.clamp_min(1 - x.abs(), 0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_comm_mask(mask: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (B, L, H, W) comm masks to ``size`` (h, w) with the
    weights of ``jax.image.resize(..., "bilinear")``, applied as one
    contraction per axis that changes. An axis that shrinks gets the
    antialiased kernel, one that grows the plain triangle, so one call
    serves the seg path's 160 x 160 -> 100 x 352. (``F.interpolate`` with
    ``antialias=True`` computes the same function, but its f32 sample
    positions round otherwise: up to 7e-6 apart on that pair.)"""
    h, w = mask.shape[-2:]
    oh, ow = (int(v) for v in size)
    if oh != h:
        wh = _resize_weights(h, oh, mask.device).to(mask.dtype)
        mask = torch.einsum("blhw,hp->blpw", mask, wh)
    if ow != w:
        ww = _resize_weights(w, ow, mask.device).to(mask.dtype)
        mask = torch.einsum("blhw,wq->blhq", mask, ww)
    return mask


class Communication(nn.Module):
    def __init__(self, threshold: float = 0.01, k_size: int = 5,
                 c_sigma: float = 1.0):
        super().__init__()
        self.threshold = threshold
        self.k_size = k_size
        self.c_sigma = c_sigma

    def forward(self, psm, agent_mask, comm_u=None, generator=None):
        """psm (B, L, AC, H, W) confidence logits -> (mask (B, L, H, W),
        comm_rate scalar tensor).

        Train mode keeps, per sample, the fraction ``comm_u`` (B,) of each
        agent's pixels; without it u is drawn from ``generator`` (a CPU
        ``torch.Generator``, so the card and the CPU draw the same u)."""
        b, l, _, h, w = psm.shape
        conf = torch.sigmoid(psm.detach()).amax(dim=2)  # (B, L, H, W)
        conf = gaussian_smooth(conf, self.k_size, self.c_sigma)
        if self.training:
            if comm_u is None:
                if generator is None:
                    raise ValueError("train-mode communication needs comm_u "
                                     "or a torch.Generator")
                comm_u = torch.rand(b, generator=generator)
            u = comm_u.to(device=conf.device, dtype=torch.float32)
            k = torch.floor(u * (h * w)).to(torch.int64)
            # a pixel is kept iff its rank among its agent's confidences is
            # below k; ranks by a stable double argsort (descending), so tied
            # confidences rank in index order, as jnp.argsort ranks them
            order = torch.argsort(-conf.reshape(b, l, h * w), dim=-1,
                                  stable=True)
            ranks = torch.argsort(order, dim=-1, stable=True)
            comm_mask = (ranks < k[:, None, None]).to(conf.dtype)
            comm_mask = comm_mask.reshape(b, l, h, w)
        else:
            comm_mask = (conf > self.threshold).to(conf.dtype)
        am = agent_mask[:, :, None, None].to(conf.dtype)
        rate = (comm_mask * am).sum() / (am.sum() * (h * w)).clamp_min(1.0)
        comm_mask[:, 0] = 1.0  # ego always communicates with itself
        return comm_mask, rate


class Where2commFusion(nn.Module):
    """Confidence-gated ego-query attention fusion, multi-scale (the shared
    backbone is passed in at call time, never registered here) or
    single-scale."""

    def __init__(self, multi_scale: bool = True, threshold: float = 0.01,
                 k_size: int = 5, c_sigma: float = 1.0):
        super().__init__()
        self.multi_scale = multi_scale
        self.communication = Communication(threshold, k_size, c_sigma)

    def forward(self, x, psm, agent_mask, backbone=None, comm_u=None,
                generator=None):
        """Multi-scale: x (B, L, H, W, C) raw BEV features and the backbone;
        single-scale: x (B, L, C, H, W) the agents' 2-D maps. psm (B, L, AC,
        H', W'); ``comm_u`` / ``generator`` as ``Communication`` takes them.

        Returns (fused (B, Cf, Hf, Wf), comm_rate)."""
        comm_mask, rate = self.communication(psm, agent_mask, comm_u,
                                             generator)
        if not self.multi_scale:
            m = comm_mask
            if m.shape[-2:] != x.shape[-2:]:
                m = resize_comm_mask(m, x.shape[-2:])
            return ego_agent_attention(x * m[:, :, None].to(x.dtype),
                                       agent_mask), rate

        b, l, h, w, c = x.shape
        ups = []
        cur = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        for i in range(len(backbone.stages)):
            cur = backbone.stage(i, cur)
            if i == 0:
                m = comm_mask
                if m.shape[-2:] != cur.shape[-2:]:
                    m = resize_comm_mask(m, cur.shape[-2:])
                cur = cur * m.reshape(b * l, 1, *cur.shape[-2:])
            grouped = cur.reshape(b, l, *cur.shape[1:])
            ups.append(backbone.deblock(i, ego_agent_attention(grouped,
                                                               agent_mask)))
        return backbone.finish(ups), rate
