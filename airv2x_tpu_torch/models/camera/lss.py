"""Lift-Splat-Shoot camera -> BEV encoder, eval and train mode
(counterpart of airv2x_tpu/models/camera/lss.py).

  * frustum: the downsampled image-plane grid times LID / UD depth bins;
  * geometry: undo the augmentation (post_rots / post_trans), unproject
    through the intrinsics, rotate and translate into the agent frame, in
    f32 without matrix products (so TF32 never enters);
  * ``CamEncoder``: the EfficientNet-b0 trunk and the Up fusion of its
    reduction_5/4/3 endpoints (or the truncated resnet101), and 1x1 context
    and depth heads; the depth
    distribution is the softmax of the depth head or the one-hot binning of
    the image's 4th (metric depth) channel (``use_depth_gt``); their outer
    product lifts the context into the frustum;
  * ``voxel_pooling``: frustum points quantised to the BEV grid and
    summed per cell by one ``index_add_`` in the features' dtype (the JAX
    package's scatter-add; on a card the order of the atomic adds, and so
    the rounding, varies between runs; its backward is the gather of the
    cells' gradients);
  * ``BevEncoder``: the resnet18 BEV head.

Tensors keep the JAX package's channel-last layout at the interfaces; the
convolutions compute in NCHW on ``channels_last`` memory.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.camera.trunks import (
    EfficientNetB0Features,
    ResNet101Trunk,
    TorchBasicBlock,
    UpBlock,
    torch_bn,
    upsample_align_corners,
)


def depth_discretization(d_min, d_max, num_bins, mode) -> np.ndarray:
    """Depth-bin starts: uniform (UD) or linear-increasing (LID) spacing."""
    if mode == "UD":
        size = (d_max - d_min) / num_bins
        return d_min + size * np.arange(num_bins)
    if mode == "LID":
        size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
        return d_min + size * (np.arange(num_bins) * np.arange(1, num_bins + 1)) / 2
    raise NotImplementedError(mode)


def bin_depth_indices(depth, mode, d_min, d_max, num_bins, target: bool):
    """Metric depth -> (bin index int32, valid mask). In target mode the mask
    is all True (the reference clamps without masking); otherwise pixels out
    of range are masked out."""
    if mode == "UD":
        size = (d_max - d_min) / num_bins
        idx = (depth - d_min) / size
    elif mode == "LID":
        size = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(1 + 8 * (depth - d_min) / size)
    else:
        raise NotImplementedError(mode)
    valid = (idx >= 0) & (idx < num_bins) & torch.isfinite(idx)
    idx = torch.where(idx < 0, 0.0, idx)  # -inf included
    idx = torch.where((idx >= num_bins) | ~torch.isfinite(idx), num_bins - 1, idx)
    idx = idx.to(torch.int32)
    if target:
        return idx, torch.ones_like(valid)
    return idx, valid


def gen_dx_bx(xbound, ybound, zbound):
    """(cell size, first cell centre, cell count) per axis."""
    dx = np.array([r[2] for r in (xbound, ybound, zbound)], np.float32)
    bx = np.array([r[0] + r[2] / 2.0 for r in (xbound, ybound, zbound)], np.float32)
    nx = np.array(
        [int((r[1] - r[0]) / r[2] + 0.5) for r in (xbound, ybound, zbound)], np.int64
    )
    return dx, bx, nx


def create_frustum(final_dim, downsample, ddiscr, mode) -> np.ndarray:
    """(D, fH, fW, 3) image-plane frustum: pixel x, pixel y, depth."""
    ogf_h, ogf_w = final_dim
    f_h, f_w = ogf_h // downsample, ogf_w // downsample
    ds = depth_discretization(*ddiscr, mode)
    d = len(ds)
    xs = np.linspace(0, ogf_w - 1, f_w)[None, None, :]
    ys = np.linspace(0, ogf_h - 1, f_h)[None, :, None]
    grid = np.zeros((d, f_h, f_w, 3), np.float32)
    grid[..., 0] = xs
    grid[..., 1] = ys
    grid[..., 2] = np.asarray(ds)[:, None, None]
    return grid


def _apply(m, p):
    """(B, N, 3, 3) matrices applied to (B, N, ..., 3) points, as sums of
    products."""
    m = m.reshape(m.shape[:2] + (1,) * (p.dim() - 3) + (3, 3))
    return (m * p[..., None, :]).sum(-1)


def _matmul(a, b):
    """(..., 3, 3) @ (..., 3, 3) as sums of products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def get_geometry(frustum, rots, trans, intrins, post_rots, post_trans):
    """Frustum (D, fH, fW, 3) -> agent-frame points (B, N, D, fH, fW, 3).

    rots / trans: camera -> agent rotation (B, N, 3, 3) / translation
    (B, N, 3); intrins (B, N, 3, 3); post_*: the augmentation transforms.
    The 3x3 inverses are LU solves in f32 (``inv_ex``: no host sync).
    """
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    pts = _apply(torch.linalg.inv_ex(post_rots)[0], pts)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    combine = _matmul(rots, torch.linalg.inv_ex(intrins)[0])
    return _apply(combine, pts) + trans[:, :, None, None, None, :]


def voxel_pooling_3d(geom, feats, dx, lo, nx):
    """Sum lifted features per grid cell, Z kept.

    geom (B, ..., 3) agent-frame points and feats (B, ..., C) in the same
    point order; ``dx`` (3,) the cell size and ``lo`` (3,) the grid's low
    corner, f32 tensors on the points' device; ``nx`` the cell counts.
    Returns (B, nz, ny, nx, C). The cell index truncates toward zero, as the
    reference's ``.long()``, so points within one cell below the low corner
    land in cell 0; points outside the grid are dropped.
    """
    b, c = geom.shape[0], feats.shape[-1]
    nx_x, nx_y, nx_z = int(nx[0]), int(nx[1]), int(nx[2])
    cells = nx_x * nx_y * nx_z
    idx = ((geom - lo) / dx).to(torch.int32).reshape(b, -1, 3)
    ix, iy, iz = idx.unbind(-1)
    valid = (
        (ix >= 0) & (ix < nx_x) & (iy >= 0) & (iy < nx_y) & (iz >= 0) & (iz < nx_z)
    )
    flat = (iz * nx_y + iy) * nx_x + ix
    # one scatter for every sample; the dropped points go to a spare row
    base = torch.arange(b, device=geom.device)[:, None] * cells
    flat = torch.where(valid, flat + base, b * cells)
    canvas = torch.zeros((b * cells + 1, c), dtype=feats.dtype,
                         device=feats.device)
    canvas.index_add_(0, flat.reshape(-1), feats.reshape(-1, c))
    return canvas[:-1].reshape(b, nx_z, nx_y, nx_x, c)


def voxel_pooling(geom, feats, dx, lo, nx):
    """``voxel_pooling_3d`` with the z slices concatenated on the channel
    axis: (B, ny, nx, C * nz) channel-last BEV."""
    out = voxel_pooling_3d(geom, feats, dx, lo, nx)
    b, nz, ny, nxx, c = out.shape
    return out.permute(0, 2, 3, 4, 1).reshape(b, ny, nxx, c * nz)


class CamEncoder(nn.Module):
    """Trunk -> depth distribution x context (lss_submodule.CamEncode and
    CamEncode_Resnet101): the EfficientNet-b0 trunk with its Up fusion, or
    ``Resnet101``'s truncated resnet (512 channels at /8, no Up blocks).
    The depth head exists only without ``use_gt_depth``, as in the flax
    module."""

    def __init__(self, depth_bins: int, context_c: int, downsample: int,
                 encoder_type: str = "EfficientNet", use_gt_depth: bool = False):
        super().__init__()
        self.up1 = self.up2 = None
        if encoder_type == "Resnet101":
            self.trunk = ResNet101Trunk()
            feat_c = 512
        elif encoder_type == "EfficientNet":
            self.trunk = EfficientNetB0Features()
            self.up1 = UpBlock(320 + 112, 256, scale=2)
            if downsample == 8:
                self.up2 = UpBlock(256 + 40, 256, scale=2)
            feat_c = 256
        else:
            raise NotImplementedError(
                f"camera_encoder {encoder_type!r}: the reference supports "
                "EfficientNet and Resnet101")
        self.image_head = nn.Conv2d(feat_c, context_c, 1)
        self.depth_head = (None if use_gt_depth
                           else nn.Conv2d(feat_c, depth_bins, 1))

    def heads(self, imgs, gt_depth_onehot=None):
        """imgs (B*, 3, H, W) -> (depth (B*, fH, fW, D), context
        (B*, fH, fW, C), depth logits (B*, fH, fW, D) or None)."""
        if self.up1 is None:
            feat = self.trunk(imgs)
        else:
            red3, red4, red5 = self.trunk(imgs)
            feat = self.up1(red5, red4)
            if self.up2 is not None:
                feat = self.up2(feat, red3)
        context = self.image_head(feat).permute(0, 2, 3, 1)
        if self.depth_head is None:
            return gt_depth_onehot.to(context.dtype), context, None
        logits = self.depth_head(feat).permute(0, 2, 3, 1)
        return torch.softmax(logits, dim=-1), context, logits

    @staticmethod
    def lift(depth, context):
        """(B*, fH, fW, D) x (B*, fH, fW, C) -> (B*, fH, fW, D, C)."""
        return depth[..., :, None] * context[..., None, :]

    def forward(self, imgs, gt_depth_onehot=None):
        depth, context, logits = self.heads(imgs, gt_depth_onehot)
        return self.lift(depth, context), logits


class BevEncoder(nn.Module):
    """resnet18 BEV head (lss_submodule.BevEncode): conv1 + layer1-3 +
    Up(64 + 256) + an upsample-conv head."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = torch_bn(64)
        self.layer1_0 = TorchBasicBlock(64, 64)
        self.layer1_1 = TorchBasicBlock(64, 64)
        self.layer2_0 = TorchBasicBlock(64, 128, stride=2, downsample=True)
        self.layer2_1 = TorchBasicBlock(128, 128)
        self.layer3_0 = TorchBasicBlock(128, 256, stride=2, downsample=True)
        self.layer3_1 = TorchBasicBlock(256, 256)
        self.up1 = UpBlock(64 + 256, 256, scale=4)
        self.up2_conv = nn.Conv2d(256, 128, 3, padding=1, bias=False)
        self.up2_bn = torch_bn(128)
        self.up2_out = nn.Conv2d(128, out_c, 1)

    def forward(self, x):
        """(B, C, H, W) -> (B, out_c, H, W)."""
        y = torch.relu(self.bn1(self.conv1(x)))
        x1 = self.layer1_1(self.layer1_0(y))
        y = self.layer2_1(self.layer2_0(x1))
        y = self.layer3_1(self.layer3_0(y))
        y = self.up1(y, x1)
        y = upsample_align_corners(y, y.shape[-2] * 2, y.shape[-1] * 2)
        y = torch.relu(self.up2_bn(self.up2_conv(y)))
        return self.up2_out(y)


class LSSCameraEncoder(nn.Module):
    """The camera branch of one agent type: images -> BEV features.

    ``cfg`` is the type's ``cam`` block (grid_conf, data_aug_conf,
    img_downsample, img_features, bevout_feature, camera_encoder,
    use_depth_gt). The frustum and the grid constants are non-persistent f32
    buffers: they move with the module and stay out of its state_dict.
    """

    def __init__(self, cfg: dict):
        super().__init__()
        grid = cfg["grid_conf"]
        self.mode, self.ddiscr = grid["mode"], grid["ddiscr"]
        self.downsample = int(cfg["img_downsample"])
        self.use_gt_depth = bool(cfg.get("use_depth_gt"))
        dx, bx, self.nx = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
        frustum = create_frustum(cfg["data_aug_conf"]["final_dim"],
                                 self.downsample, self.ddiscr, self.mode)
        self.register_buffer("frustum", torch.from_numpy(frustum),
                             persistent=False)
        self.register_buffer("dx", torch.from_numpy(dx), persistent=False)
        # the grid's low corner, bx - dx / 2 in f32 as the JAX package has it
        self.register_buffer("lo", torch.from_numpy(bx - dx / 2.0),
                             persistent=False)
        self.camencode = CamEncoder(
            depth_bins=frustum.shape[0],
            context_c=int(cfg["img_features"]),
            downsample=self.downsample,
            encoder_type=str(cfg.get("camera_encoder", "EfficientNet")),
            use_gt_depth=self.use_gt_depth,
        )
        self.out_channels = int(cfg["bevout_feature"])
        self.bevencode = BevEncoder(int(cfg["img_features"]) * int(self.nx[2]),
                                    self.out_channels)

    def gt_depth_onehot(self, depth_map):
        """The image's metric depth (B*, H, W) -> (B*, fH, fW, D) one-hot of
        its bin at each downsampled pixel centre, as get_gt_depth_dist: in
        eval mode zero where out of range, in train mode clamped to the end
        bins (the JAX package's ``target=train``)."""
        d_min, d_max, n_bins = self.ddiscr
        depth_map = torch.clamp(depth_map, max=float(d_max))
        idx, valid = bin_depth_indices(depth_map, self.mode, d_min, d_max,
                                       n_bins, target=self.training)
        s = self.downsample
        idx = idx[:, s // 2::s, s // 2::s]
        valid = valid[:, s // 2::s, s // 2::s]
        return F.one_hot(idx.long(), n_bins) * valid[..., None]

    def forward(self, cam_inputs: dict, mark=None):
        """cam_inputs: imgs (B*, Ncam, H, W, 3[+1]), intrinsics / rots /
        post_rots (B*, Ncam, 3, 3), trans / post_trans (B*, Ncam, 3).
        Returns (B*, ny, nx, bevout_feature) in the weights' dtype.

        ``mark``, if given, is called with a stage name after each stage
        ("trunks+heads", "lift+voxel pooling", "BEV encoder"), for timing."""
        imgs = cam_inputs["imgs"]
        b, ncam = imgs.shape[:2]
        dtype = self.camencode.image_head.weight.dtype
        flat = imgs.reshape((b * ncam,) + imgs.shape[2:])
        rgb = flat[..., :3].permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        gt = None
        if self.use_gt_depth:
            if flat.shape[-1] < 4:
                raise ValueError("use_depth_gt needs the images' depth channel")
            gt = self.gt_depth_onehot(flat[..., 3])
        depth, context, _ = self.camencode.heads(rgb, gt)
        if mark is not None:
            mark("trunks+heads")

        lifted = CamEncoder.lift(depth, context)  # (B*N, fH, fW, D, C)
        lifted = lifted.reshape((b, ncam) + lifted.shape[1:])
        # the geometry is f32 in every dtype, as in JAX (also after .double())
        geom = get_geometry(
            self.frustum.float(),
            *(cam_inputs[k].float() for k in ("rots", "trans", "intrinsics",
                                              "post_rots", "post_trans")),
        )  # (B, N, D, fH, fW, 3): in the lifted order (B, N, fH, fW, D)
        bev = voxel_pooling(geom.permute(0, 1, 3, 4, 2, 5), lifted,
                            self.dx.float(), self.lo.float(), self.nx)
        if mark is not None:
            mark("lift+voxel pooling")

        out = self.bevencode(bev.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if mark is not None:
            mark("BEV encoder")
        return out
