"""Where2comm fusion, eval mode (counterpart of
airv2x_tpu/models/fusion/where2comm.py).

Communication: sigmoid confidence -> max over anchor/class channels -> fixed
5x5 *unnormalised* gaussian (SAME padding) -> ``conf > threshold``; the rate
is measured before the ego row is forced on. Multi-scale fusion reruns the
shared backbone stages on the raw BEV features, gates stage 0 with the mask
and fuses agents with ego-query attention at every scale.
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


class Communication(nn.Module):
    def __init__(self, threshold: float = 0.01, k_size: int = 5,
                 c_sigma: float = 1.0):
        super().__init__()
        self.threshold = threshold
        self.k_size = k_size
        self.c_sigma = c_sigma

    def forward(self, psm, agent_mask):
        """psm (B, L, AC, H, W) confidence logits -> (mask (B, L, H, W),
        comm_rate scalar tensor)."""
        if self.training:
            raise NotImplementedError("training-mode communication waits")
        h, w = psm.shape[-2:]
        conf = torch.sigmoid(psm).amax(dim=2)  # (B, L, H, W)
        conf = gaussian_smooth(conf, self.k_size, self.c_sigma)
        comm_mask = (conf > self.threshold).to(conf.dtype)
        am = agent_mask[:, :, None, None].to(conf.dtype)
        rate = (comm_mask * am).sum() / (am.sum() * (h * w)).clamp_min(1.0)
        comm_mask[:, 0] = 1.0  # ego always communicates with itself
        return comm_mask, rate


class Where2commFusion(nn.Module):
    """Multi-scale confidence-gated ego-query attention fusion. The shared
    backbone is passed in at call time, never registered here."""

    def __init__(self, multi_scale: bool = True, threshold: float = 0.01,
                 k_size: int = 5, c_sigma: float = 1.0):
        super().__init__()
        if not multi_scale:
            raise NotImplementedError("single-scale Where2comm is not ported")
        self.communication = Communication(threshold, k_size, c_sigma)

    def forward(self, x, psm, agent_mask, backbone):
        """x (B, L, H, W, C) raw BEV features; psm (B, L, AC, H', W').

        Returns (fused (B, Cf, Hf, Wf), comm_rate)."""
        b, l, h, w, c = x.shape
        comm_mask, rate = self.communication(psm, agent_mask)

        ups = []
        cur = x.reshape(b * l, h, w, c).permute(0, 3, 1, 2)
        for i in range(len(backbone.stages)):
            cur = backbone.stage(i, cur)
            if i == 0:
                m = comm_mask
                if m.shape[-2:] != cur.shape[-2:]:
                    # antialias matches jax.image.resize when downsampling
                    m = F.interpolate(m, size=cur.shape[-2:], mode="bilinear",
                                      align_corners=False, antialias=True)
                cur = cur * m.reshape(b * l, 1, *cur.shape[-2:])
            grouped = cur.reshape(b, l, *cur.shape[1:])
            ups.append(backbone.deblock(i, ego_agent_attention(grouped,
                                                               agent_mask)))
        return backbone.finish(ups), rate
