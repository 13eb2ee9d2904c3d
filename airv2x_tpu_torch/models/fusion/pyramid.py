"""HEAL pyramid fusion (counterpart of airv2x_tpu/models/fusion/pyramid.py):
a (ResNeXt) BEV pyramid with a 1x1 occupancy head per level; per level the
agents' features and their sigmoid occupancy scores are warped into the ego
frame and fused by a softmax over the agents of the warped scores (pixels
where a score is exactly 0, outside an agent's warped footprint, left
out); the fused levels are deconv-decoded and concatenated.

The pyramid runs NCHW per agent; the warp and the fuse run channels-last,
as in the JAX package. The warp samples on an f32 grid, so the fused levels
are f32 under a bf16 compute dtype and each deblock casts its input to its
weight's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.common import NEG_INF
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from airv2x_tpu_torch.ops.warp import (
    device_scalar, normalized_pairwise_affine, warp_affine_normalized)


def weighted_fuse(feats, scores, agent_mask, aff_to_ego, align_corners=False):
    """feats (B, L, H, W, C), scores (B, L, H, W, 1), agent_mask (B, L),
    aff_to_ego (B, L, 2, 3) normalized affines into the ego frame ->
    (B, H, W, C): per pixel the softmax over the present agents whose warped
    score is not exactly 0, weighting their warped features (0 where no
    agent counts)."""
    warped_f = warp_affine_normalized(feats, aff_to_ego,
                                      align_corners=align_corners)
    warped_s = warp_affine_normalized(scores, aff_to_ego,
                                      align_corners=align_corners)
    s = warped_s[..., 0]  # (B, L, H, W)
    valid = (s != 0.0) & agent_mask[:, :, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    s = s - s.amax(dim=1, keepdim=True)
    wts = torch.exp(s) * valid.to(feats.dtype)
    denom = wts.sum(dim=1, keepdim=True)
    wts = torch.where(denom > 0, wts / denom.clamp_min(1e-9),
                      torch.zeros_like(wts))
    return (warped_f * wts[..., None]).sum(dim=1)


def cam_crop_mask(h: int, w: int, crop_ratios, dtype=torch.float32):
    """(B, L, h, w, 1) validity of each agent's BEV map: a camera agent
    (ratio > 0) keeps only its central window of ``dim / ratio - 4`` cells
    per axis, from ``dim // 2 - crop // 2`` on (both floored), a LiDAR
    agent (ratio <= 0) the whole map. ``crop_ratios`` (B, L, 2) holds
    [ratio_h, ratio_w] per agent."""
    rh, rw = crop_ratios[..., 0], crop_ratios[..., 1]

    def extent(r, n):
        # a true division on the card too (a host scalar over a tensor is
        # its reciprocal times the scalar there)
        crop = torch.where(r > 0, device_scalar(n, r) / r.clamp_min(1e-6) - 4.0,
                           torch.full_like(r, float(n)))
        half = torch.floor(crop / 2)
        return torch.floor(n // 2 - half), torch.floor(n // 2 + half)

    sh, eh = extent(rh, h)
    sw, ew = extent(rw, w)
    ys = torch.arange(h, dtype=torch.float32, device=crop_ratios.device)
    xs = torch.arange(w, dtype=torch.float32, device=crop_ratios.device)
    in_h = (ys >= sh[..., None]) & (ys < eh[..., None])
    in_w = (xs >= sw[..., None]) & (xs < ew[..., None])
    mask = in_h[..., :, None] & in_w[..., None, :]
    return mask.to(dtype)[..., None]


class PyramidFusion(nn.Module):
    """The ResNeXt pyramid (``fusion_backbone``), its per-level occupancy
    heads (flax ``single_head_{i}``) and the weighted warp-fuse. ``in_ch``
    is the width of the maps it receives, ``inplanes`` the config's (which
    decides, as in the JAX package, whether the first block projects its
    identity)."""

    FLAX_NAMES = {"occ_heads": "single_head"}

    def __init__(self, args: dict, inplanes: int = 64, in_ch: int | None = None):
        super().__init__()
        planes = int(args.get("inplanes", inplanes))
        self.resnet = ResNetBEVBackbone(
            layer_nums=args["layer_nums"],
            layer_strides=args["layer_strides"],
            num_filters=args["num_filters"],
            upsample_strides=args.get("upsample_strides", ()),
            num_upsample_filters=args.get("num_upsample_filter", ()),
            inplanes=planes,
            in_ch=planes if in_ch is None else in_ch,
            resnext=bool(args.get("resnext")),
        )
        self.occ_heads = nn.ModuleList(
            nn.Conv2d(f, 1, 1) for f in args["num_filters"])
        self.align_corners = bool(args.get("align_corners", False))
        self.out_channels = self.resnet.out_channels

    def forward_single(self, x):
        """One agent's pass: (N, C, H, W) -> (decoded map, [occupancy
        logits (N, 1, h_i, w_i)])."""
        feats = self.resnet.get_multiscale_feature(x)
        occ = [head(f) for head, f in zip(self.occ_heads, feats)]
        return self.resnet.decode_multiscale(feats), occ

    def forward_collab(self, x, agent_mask, pairwise_t, discrete_ratio,
                       downsample_rate, cam_crop_ratios=None):
        """x (B, L, C, H, W), pairwise_t (B, L, 4, 4) agent -> ego, optional
        ``cam_crop_ratios`` (B, L, 2) (``cam_crop_mask``) -> (fused (B, Cf,
        Hf, Wf), [occupancy logits (B * L, 1, h_i, w_i)]). The affine of
        level i takes its own map size and ``downsample_rate`` (the
        modality backbone's stride), as in the JAX package."""
        b, l = x.shape[:2]
        feats = self.resnet.get_multiscale_feature(x.flatten(0, 1))
        fused_levels, occ_maps = [], []
        for head, f in zip(self.occ_heads, feats):
            occ = head(f)
            occ_maps.append(occ)
            score = torch.sigmoid(occ) + 1e-4
            h, w = f.shape[-2:]
            fg = f.reshape((b, l) + f.shape[1:]).permute(0, 1, 3, 4, 2)
            sg = score.reshape((b, l) + score.shape[1:]).permute(0, 1, 3, 4, 2)
            if cam_crop_ratios is not None:
                sg = sg * cam_crop_mask(h, w, cam_crop_ratios, sg.dtype)
            aff = normalized_pairwise_affine(pairwise_t, h, w, discrete_ratio,
                                             downsample_rate)
            fused = weighted_fuse(fg, sg, agent_mask, aff, self.align_corners)
            fused_levels.append(fused.permute(0, 3, 1, 2))
        return self.resnet.decode_multiscale(fused_levels), occ_maps
