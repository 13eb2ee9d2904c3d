"""MDD: radar-conditioned diffusion denoising of LiDAR BEV features
(counterpart of airv2x_tpu/models/fusion/mdd.py), NCHW.

  * ``DiffusionUNet``: the DDIM-style UNet. GroupNorm(4, eps 1e-6) + swish
    ``ResnetBlockDDIM``s with a timestep projection, ``AttnBlockDDIM`` where
    the running resolution (``resolution``, fixed at 128 upstream, halved
    per level) is in ``attn_resolutions``, a stride-2 3x3 conv after a
    right / bottom pad of one to go down, nearest x2 and a 3x3 conv to go up.
    Its input is [condition, noisy] on channels, twice ``in_channels``.
  * ``mdd_beta_schedule``: the linear-sqrt betas between the endpoints the
    reference hardcodes (5e-3, 5e-2; the YAML's beta_start / beta_end are
    read by neither package), in float64, then f32.
  * ``CondDiffDenoise``: the degraded LiDAR map noised to t = T - 1, then
    the whole reverse chain conditioned on the radar map, the x0
    prediction of t = 0 returned. The T gaussian draws are the batch's
    ``mdd_noises`` (T, B * L, H, W, C) where given (the parity tests give
    both packages the same); else ``default_noises`` draws them on the maps'
    device: in training from a seed the train step's per-step ``generator``
    gives (new draws every step, as JAX's per-step "diffusion" rng), in
    eval from ``NOISE_SEED`` (JAX's fixed ``PRNGKey(0)``, whose draws cannot
    be reproduced: ROADMAP §3).

The chain's state stays f32 under a bf16 compute dtype, as the JAX package's
does (its f32 schedule constants promote it); each conv casts its input to
its weight's dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NOISE_SEED = 0  # the default draws' generator seed (no ``mdd_noises`` given)
GN_GROUPS = 4
GN_EPS = 1e-6


def get_timestep_embedding(t, embedding_dim: int):
    """Sinusoidal embedding (B,) -> (B, dim): the ``(half - 1)``
    denominator, [sin, cos] order, zero padded where dim is odd."""
    half = embedding_dim // 2
    scale = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -scale)
    ang = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _swish(x):
    return x * torch.sigmoid(x)


class GroupNorm(nn.GroupNorm):
    """flax ``GroupNorm`` on NCHW: f32 statistics over each group's
    channels and pixels with the variance E[x^2] - E[x]^2 clamped at 0,
    the result cast to x's dtype. ``cast_weights_`` keeps it f32."""

    def __init__(self, channels: int):
        super().__init__(GN_GROUPS, channels, eps=GN_EPS)

    def forward(self, x):
        b, c = x.shape[:2]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        g = xf.reshape(b, self.num_groups, -1)
        mean = g.mean(-1, keepdim=True)
        var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((g - mean) * torch.rsqrt(var + self.eps)).reshape(xf.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        return (y * self.weight.reshape(shape)
                + self.bias.reshape(shape)).to(x.dtype)


def _conv(conv: nn.Conv2d, x):
    return conv(x.to(conv.weight.dtype))


class ResnetBlockDDIM(nn.Module):
    """norm - swish - conv, plus the timestep projection, norm - swish -
    (dropout 0) - conv; a 1x1 shortcut where the width changes."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                             else None)

    def forward(self, x, temb):
        h = _conv(self.conv1, _swish(self.norm1(x)))
        t = _swish(temb).to(self.temb_proj.weight.dtype)
        h = h + self.temb_proj(t)[:, :, None, None]
        h = _conv(self.conv2, _swish(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = _conv(self.nin_shortcut, x)
        return x + h


class AttnBlockDDIM(nn.Module):
    """Full spatial self-attention with 1x1-conv q / k / v and output."""

    def __init__(self, c: int):
        super().__init__()
        self.norm = GroupNorm(c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1)
                                                 for _ in range(4))

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        q, k, v = (_conv(m, h).reshape(b, c, hh * ww) for m in (self.q, self.k,
                                                                  self.v))
        attn = torch.softmax(torch.einsum("bci,bcj->bij", q, k) * c ** -0.5,
                             dim=2)
        out = torch.einsum("bij,bcj->bci", attn, v).reshape(b, c, hh, ww)
        return x + _conv(self.proj_out, out)


class _Downsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, stride=2) if with_conv else None

    def forward(self, x):
        if self.conv is None:
            return F.avg_pool2d(x, 2, 2)
        return _conv(self.conv, F.pad(x, (0, 1, 0, 1)))


class _Upsample(nn.Module):
    def __init__(self, c: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1) if with_conv else None

    def forward(self, x):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return x if self.conv is None else _conv(self.conv, x)


class DiffusionUNet(nn.Module):
    """The DDIM UNet; children carry the flax scope names
    (``down_{level}_block_{i}``, ``mid_block_1``, ``up_{level}_upsample``,
    ...)."""

    def __init__(self, in_channels: int, ch: int, out_ch: int, ch_mult,
                 num_res_blocks: int, attn_resolutions, dropout: float = 0.0,
                 resamp_with_conv: bool = True, resolution: int = 128):
        super().__init__()
        if float(dropout) != 0.0:
            raise NotImplementedError("MDD's UNet dropout is not ported")
        self.ch, self.ch_mult = int(ch), tuple(int(m) for m in ch_mult)
        self.num_res_blocks = int(num_res_blocks)
        attn_res = {int(r) for r in attn_resolutions}
        temb_ch = 4 * self.ch
        self.temb_dense_0 = nn.Linear(self.ch, temb_ch)
        self.temb_dense_1 = nn.Linear(temb_ch, temb_ch)
        self.conv_in = nn.Conv2d(2 * int(in_channels), self.ch, 3, padding=1)
        skips, cur, res = [self.ch], self.ch, int(resolution)
        levels = len(self.ch_mult)
        self.attn_at = set()
        for lv in range(levels):
            out = self.ch * self.ch_mult[lv]
            for i in range(self.num_res_blocks):
                self.add_module(f"down_{lv}_block_{i}",
                                ResnetBlockDDIM(cur, out, temb_ch))
                cur = out
                if res in attn_res:
                    self.add_module(f"down_{lv}_attn_{i}", AttnBlockDDIM(cur))
                    self.attn_at.add(f"down_{lv}_attn_{i}")
                skips.append(cur)
            if lv != levels - 1:
                self.add_module(f"down_{lv}_downsample",
                                _Downsample(cur, resamp_with_conv))
                skips.append(cur)
                res //= 2
        self.mid_block_1 = ResnetBlockDDIM(cur, cur, temb_ch)
        self.mid_block_2 = ResnetBlockDDIM(cur, cur, temb_ch)
        for lv in reversed(range(levels)):
            out = self.ch * self.ch_mult[lv]
            for i in range(self.num_res_blocks + 1):
                self.add_module(f"up_{lv}_block_{i}",
                                ResnetBlockDDIM(cur + skips.pop(), out, temb_ch))
                cur = out
                if res in attn_res:
                    self.add_module(f"up_{lv}_attn_{i}", AttnBlockDDIM(cur))
                    self.attn_at.add(f"up_{lv}_attn_{i}")
            if lv != 0:
                self.add_module(f"up_{lv}_upsample",
                                _Upsample(cur, resamp_with_conv))
                res *= 2
        self.norm_out = GroupNorm(cur)
        self.conv_out = nn.Conv2d(cur, int(out_ch), 3, padding=1)

    def _attn(self, name, h):
        return self.get_submodule(name)(h) if name in self.attn_at else h

    def forward(self, x, t):
        """x (B, 2 C, H, W), t (B,) -> the x0 prediction (B, out_ch, H, W)."""
        dense = self.temb_dense_0
        temb = dense(get_timestep_embedding(t, self.ch).to(dense.weight.dtype))
        temb = self.temb_dense_1(_swish(temb))
        hs = [_conv(self.conv_in, x)]
        levels = len(self.ch_mult)
        for lv in range(levels):
            for i in range(self.num_res_blocks):
                h = self.get_submodule(f"down_{lv}_block_{i}")(hs[-1], temb)
                hs.append(self._attn(f"down_{lv}_attn_{i}", h))
            if lv != levels - 1:
                hs.append(self.get_submodule(f"down_{lv}_downsample")(hs[-1]))
        h = self.mid_block_2(self.mid_block_1(hs[-1], temb), temb)
        for lv in reversed(range(levels)):
            for i in range(self.num_res_blocks + 1):
                h = self.get_submodule(f"up_{lv}_block_{i}")(
                    torch.cat([h, hs.pop().to(h.dtype)], dim=1), temb)
                h = self._attn(f"up_{lv}_attn_{i}", h)
            if lv != 0:
                h = self.get_submodule(f"up_{lv}_upsample")(h)
        return _conv(self.conv_out, _swish(self.norm_out(h)))


def mdd_beta_schedule(num_timesteps: int) -> dict:
    """The schedule's f32 constants (numpy), computed in float64."""
    betas = np.linspace(math.sqrt(5e-3), math.sqrt(5e-2), num_timesteps,
                        dtype=np.float64) ** 2
    alphas = 1.0 - betas
    cum = np.cumprod(alphas, axis=0)
    prev = np.append(1.0, cum[:-1])
    post_var = betas * (1.0 - prev) / (1.0 - cum)
    return {
        "sqrt_alphas_cumprod": np.sqrt(cum).astype(np.float32),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - cum).astype(np.float32),
        "posterior_mean_coef1": (betas * np.sqrt(prev) / (1.0 - cum)).astype(
            np.float32),
        "posterior_mean_coef2": ((1.0 - prev) * np.sqrt(alphas)
                                 / (1.0 - cum)).astype(np.float32),
        "posterior_log_variance_clipped": np.log(
            np.maximum(post_var, 1e-20)).astype(np.float32),
    }


def default_noises(shape, device, generator=None):
    """The chain's T draws (T, N, C, H, W) f32 on ``device``: seeded from the
    CPU ``generator`` where given (the train step's), else ``NOISE_SEED``."""
    seed = NOISE_SEED if generator is None else int(
        torch.randint(0, 2 ** 62, (), generator=generator))
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32)


class CondDiffDenoise(nn.Module):
    """The radar-conditioned reverse chain around ``DiffusionUNet``
    (flax scope ``denoiser``)."""

    def __init__(self, model_cfg: dict, num_timesteps: int):
        super().__init__()
        m = model_cfg
        self.denoiser = DiffusionUNet(
            in_channels=int(m["in_channels"]), ch=int(m["ch"]),
            out_ch=int(m["out_ch"]), ch_mult=tuple(m["ch_mult"]),
            num_res_blocks=int(m["num_res_blocks"]),
            attn_resolutions=tuple(m["attn_resolutions"]),
            dropout=float(m.get("dropout", 0.0)),
            resamp_with_conv=bool(m.get("resamp_with_conv", True)))
        self.num_timesteps = int(num_timesteps)
        self.sched = mdd_beta_schedule(self.num_timesteps)

    def forward(self, lidar_bev, radar_bev, noises=None, generator=None):
        """lidar_bev / radar_bev (N, C, H, W); ``noises`` (T, N, H, W, C)
        (the JAX layout), else drawn by ``default_noises`` from ``generator``
        -> the denoised x0 (N, C, H, W)."""
        s, T = self.sched, self.num_timesteps
        if noises is None:
            noises = default_noises((T,) + lidar_bev.shape, lidar_bev.device,
                                    generator)
        else:
            noises = noises.permute(0, 1, 4, 2, 3)
        f32 = torch.float32
        x = (float(s["sqrt_alphas_cumprod"][T - 1]) * lidar_bev.to(f32)
             + float(s["sqrt_one_minus_alphas_cumprod"][T - 1]) * noises[0].to(f32))
        n = lidar_bev.shape[0]
        for step, t in enumerate(range(T - 1, -1, -1)):
            tt = torch.full((n,), float(t), dtype=f32, device=x.device)
            x0 = self.denoiser(torch.cat([radar_bev.to(f32), x], dim=1), tt)
            if t == 0:
                return x0
            mean = (float(s["posterior_mean_coef1"][t]) * x0.to(f32)
                    + float(s["posterior_mean_coef2"][t]) * x)
            sigma = math.exp(0.5 * float(s["posterior_log_variance_clipped"][t]))
            x = mean + sigma * noises[step + 1].to(f32)
        return x
