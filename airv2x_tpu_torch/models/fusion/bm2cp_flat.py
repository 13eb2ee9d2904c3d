"""BM2CP's building blocks (counterpart of
airv2x_tpu/models/fusion/bm2cp_flat.py), shared by the AirV2X and the flat
OPV2V / DAIR BM2CP models.

  * ``BM2CPUp``: align-corners upsample, pad, concat, then ONE conv-BN-ReLU
    (the LSS Up has two);
  * ``ImgCamEncode``: the EfficientNet-b0 trunk, the Up fusion, and the
    image and depth heads. The observed depth map (in bin units, -1 where no
    LiDAR return projects) is min-pooled to the feature resolution; where
    a bin is observed its one-hot replaces the predicted depth softmax;
  * ``fuse_ego_depth``: the two-view ego composite of the depth maps;
  * ``MultiModalFusion`` / ``ImgModalFusion``: the occupancy-routed fusion
    of the camera and the pillar volumes, with a gated blend where both are
    occupied, a per-voxel attention mask for camera-only voxels, and the
    threshold map that the collaborative stage compares the confidence
    with;
  * ``atten_comm_fuse``: AttenComm, the collaborative stage: confidence
    against threshold-map communication masks (the even-slot always-send
    quirk kept) and per-level pixel-wise agent self-attention.

Tensors are channel-last at the interfaces, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.camera.trunks import (
    EfficientNetB0Features, pad_or_crop_to, torch_bn, upsample_align_corners)
from airv2x_tpu_torch.models.fusion.scope import atten_fusion
from airv2x_tpu_torch.models.fusion.where2comm import resize_comm_mask
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


class PointwiseConv3d(nn.Conv3d):
    """A 1x1x1 ``nn.Conv3d`` (flax ``Conv`` with a (1, 1, 1) kernel) applied
    to channel-last (..., C) volumes as one matmul."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__(in_c, out_c, 1)

    def forward(self, x):
        w = self.weight.flatten(1)
        return F.linear(x.to(w.dtype), w, self.bias)


class BM2CPUp(nn.Module):
    """sensor_blocks.Up: upsample x by ``scale`` (align corners), pad or crop
    to the skip, concat [skip, x], then one conv3x3-BN-ReLU."""

    def __init__(self, in_c: int, out_c: int, scale: int = 2):
        super().__init__()
        self.scale = scale
        self.conv0 = nn.Conv2d(in_c, out_c, 3, padding=1, bias=False)
        self.bn0 = torch_bn(out_c)

    def forward(self, x, skip):
        x = upsample_align_corners(x, x.shape[-2] * self.scale,
                                   x.shape[-1] * self.scale)
        x = pad_or_crop_to(x, skip.shape[-2], skip.shape[-1])
        return torch.relu(self.bn0(self.conv0(torch.cat([skip, x], dim=1))))


def pool_observed_depth(depth_map, f_h: int, f_w: int):
    """(B*, H, W) depth levels, negative where unobserved -> (B*, f_h, f_w)
    by the reference's min-pool: the unobserved pixels become the batch's
    maximum + 1, the pool takes each window's minimum, and a window with no
    observed pixel (or only level 0) reads 0 (sensor_blocks.py:177-188)."""
    h, w = depth_map.shape[-2:]
    max_value = depth_map.max()
    d = torch.where(depth_map < 0, max_value + 1, depth_map)
    sh, sw = h // f_h, w // f_w
    d = -F.max_pool2d(-d[:, None], (sh, sw), stride=(sh, sw))[:, 0]
    return torch.where(d > max_value, torch.zeros_like(d), d)


class ImgCamEncode(nn.Module):
    """sensor_blocks.ImgCamEncode: images + observed depth -> lifted
    features (B*, fH, fW, D, C)."""

    def __init__(self, depth_bins: int, context_c: int, downsample: int):
        super().__init__()
        self.depth_bins = depth_bins
        self.trunk = EfficientNetB0Features()
        self.up1 = BM2CPUp(320 + 112, 256)
        self.up2 = BM2CPUp(256 + 40, 256) if downsample == 8 else None
        self.image_head = nn.Conv2d(256, context_c, 1)
        self.depth_head = nn.Conv2d(256, depth_bins, 1)

    def forward(self, imgs, depth_map):
        """imgs (B*, 3, H, W) in the weights' dtype; depth_map (B*, H, W)
        f32 in bin units. The one-hot is f32, so the lifted features are
        f32 in every compute dtype, as in the JAX package."""
        red3, red4, red5 = self.trunk(imgs)
        feat = self.up1(red5, red4)
        if self.up2 is not None:
            feat = self.up2(feat, red3)
        context = self.image_head(feat).permute(0, 2, 3, 1)
        d = pool_observed_depth(depth_map.float(), feat.shape[-2], feat.shape[-1])
        one_hot = F.one_hot(
            d.to(torch.int32).clamp(0, self.depth_bins - 1).long(),
            self.depth_bins).to(torch.float32)
        logits = self.depth_head(feat).permute(0, 2, 3, 1)
        depth = torch.where((d > 0)[..., None], one_hot,
                            torch.softmax(logits, dim=-1))
        return depth[..., :, None] * context[..., None, :]


def fuse_ego_depth(depth_maps, agent_mask):
    """The two-view ego composite (sensor_blocks.py:133-164): each sample's
    ego depth map is filled, where unobserved, by the minimum over the
    present agents' ego-view projections.

    depth_maps (B, L, 2, H, W): [:, :, 0] the self view, [:, :, 1] the ego
    view (negative = unobserved). Returns per-agent maps (B, L, H, W)."""
    self_view, ego_view = depth_maps[:, :, 0], depth_maps[:, :, 1]
    big = ego_view.max() + 1.0
    m = agent_mask[:, :, None, None].bool()
    candidates = torch.where((ego_view < 0) | ~m, big, ego_view)
    fused = candidates.amin(dim=1)
    fused = torch.where(fused >= big, torch.full_like(fused, -1.0), fused)
    ego_mask = (self_view[:, 0] > 0).to(fused.dtype)
    new_ego = self_view[:, 0] * ego_mask + fused * (1.0 - ego_mask)
    return torch.cat([new_ego[:, None], self_view[:, 1:]], dim=1)


class MultiModalFusion(nn.Module):
    """sensor_blocks.MultiModalFusion with ImgModalFusion, channel-last."""

    def __init__(self, dim: int, threshold: float = 0.5):
        super().__init__()
        self.threshold = threshold
        self.multigate = PointwiseConv3d(dim, dim)
        self.multifuse = PointwiseConv3d(2 * dim, dim)
        self.img_proj = nn.Linear(dim, dim)

    def forward(self, img_voxel, pc_voxel):
        """img / pc voxel (B, Z, Y, X, C) -> (fused (B, Y, X, C * Z),
        threshold map (B, Y, X, 1), mask code (B, Y, X, 1)). Mixed inputs
        (the f32 camera volume, a bf16 pillar volume) promote as JAX's."""
        b, z, y, x, c = pc_voxel.shape
        pdt = pc_voxel.dtype
        pc_mask = (pc_voxel != 0).to(pdt).amax(-1, keepdim=True)
        img_mask = (img_voxel != 0).to(pdt).amax(-1, keepdim=True)
        gate = torch.relu(self.multigate(pc_voxel))
        blended = self.multifuse(torch.cat(
            [gate * img_voxel, pc_voxel.to(torch.promote_types(pdt, img_voxel.dtype))],
            dim=-1))

        # ImgModalFusion: channel attention of the pillar volume over the
        # camera volume, then a per-voxel mask for camera-only voxels
        dt = torch.promote_types(pdt, img_voxel.dtype)
        pc_flat = pc_voxel.reshape(b, -1, c).to(dt)
        img_flat = img_voxel.reshape(b, -1, c).to(dt)
        score = torch.einsum("bnc,bnd->bcd", pc_flat, img_flat) / math.sqrt(c)
        attn = torch.softmax(score, dim=-1)
        vmask = torch.einsum("bcd,bnd->bnc", attn, img_flat)
        vmask = torch.sigmoid(self.img_proj(vmask.to(self.img_proj.weight.dtype)))
        vmask = (vmask > self.threshold).to(pdt).reshape(b, z, y, x, c)
        vmask = torch.cat([torch.ones_like(vmask[:1]), vmask[1:]])  # row 0 kept

        fused = (pc_mask * img_mask * blended
                 + pc_voxel * pc_mask * (1 - img_mask)
                 + img_voxel * vmask * (1 - pc_mask) * img_mask)
        thres = (pc_mask * (1 - img_mask) * 0.5
                 + (1 - pc_mask) * img_mask * 0.5
                 + (1 - pc_mask) * (1 - img_mask) * 0.5)
        mask_code = (pc_mask * img_mask + pc_mask * (1 - img_mask) * 2
                     + (1 - pc_mask) * img_mask * 3
                     + (1 - pc_mask) * (1 - img_mask) * 4)
        fused_2d = fused.permute(0, 2, 3, 4, 1).reshape(b, y, x, c * z)
        return fused_2d, thres.amin(1), mask_code.amin(1)


def atten_comm_fuse(backbone, x, feats_2d, conf, thres, pairwise_t_full,
                    agent_mask, *, mask_dtype, discrete_ratio: float,
                    downsample_rate: float = 1.0, multi_scale: bool = True):
    """AttenComm (attentioncomm.py:106-260) over the agent slots.

    x (B*L, C, Y, X) the modal-fused maps in the backbone's dtype (the
    multi-scale path re-runs the backbone's stages on them), feats_2d
    (B*L, C', H, W) their backbone + shrink output, conf (B, L, h, w) each
    agent's confidence, thres (B, L, Y, X) its threshold map, ``mask_dtype``
    the dtype of the masks (the modal fusion's output dtype). The threshold
    map is resized to the confidence and the mask to the first level by
    ``jax.image.resize``'s bilinear weights (antialiased where they shrink).
    Every even slot always sends, as the reference's present-agent index
    does when the slots are filled front to back.

    Returns (the fused map (B, C'', H, W) before the shrink: the
    concatenated deblocks in the multi-scale path, else the fused
    ``feats_2d``; comm_rate, the ego's mean mask)."""
    b, l = agent_mask.shape
    aff = normalized_pairwise_affine(pairwise_t_full, x.shape[-2], x.shape[-1],
                                     discrete_ratio, downsample_rate)[:, 0]

    def warp_slots(v):  # (B, L, H, W, C)
        return torch.cat([v[:, :1], warp_affine_normalized(v[:, 1:], aff[:, 1:])],
                         dim=1)

    def resized(m, hw):
        return m if tuple(m.shape[-2:]) == tuple(hw) else resize_comm_mask(m, hw)

    comm = (conf > resized(thres, conf.shape[-2:])).to(mask_dtype)
    even = (torch.arange(l, device=comm.device) % 2 == 0)[None, :, None, None]
    comm = torch.where(even, torch.ones_like(comm), comm)
    rate = (comm[:, 0].sum((1, 2)) / (comm.shape[-2] * comm.shape[-1])).mean()
    mask5 = agent_mask[:, :, None, None, None].to(mask_dtype)
    if not multi_scale:
        f = feats_2d.unflatten(0, (b, l)).permute(0, 1, 3, 4, 2)
        f = f * resized(comm, f.shape[2:4])[..., None]
        fused = atten_fusion(warp_slots(f) * mask5, agent_mask)
        return fused.permute(0, 3, 1, 2), rate
    ups = []
    for i, f in enumerate(backbone.get_multiscale_feature(x)):
        xi = f.unflatten(0, (b, l)).permute(0, 1, 3, 4, 2)
        if i == 0:
            xi = xi * resized(comm, xi.shape[2:4])[..., None]
        xi = warp_slots(xi) * mask5
        dec = backbone.deblocks[i]
        ups.append(dec(atten_fusion(xi, agent_mask).permute(0, 3, 1, 2)
                       .to(dec.deconv.weight.dtype)))
    return (torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]), rate
