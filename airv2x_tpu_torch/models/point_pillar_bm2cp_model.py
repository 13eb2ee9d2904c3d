"""Flat BM2CP (counterpart of airv2x_tpu/models/point_pillar_bm2cp_model.py:
``bm2cp_voxel_pooling`` and ``point_pillar_bm2cp``, for the OPV2V / DAIR
``*_bm2cp`` configs).

The shared pillar encoder (one K1 launch per call) gives each agent's BEV
map, kept as a volume with Z = 1; the camera branch lifts EfficientNet
features with the observed-depth one-hot blending (``ImgCamEncode``) and
pools them into the voxel grid without collapsing Z; ``MultiModalFusion``
routes the two volumes by occupancy into a fused BEV map and a threshold
map; the ResNet backbone and AttenComm fuse the agents per level with
confidence-against-threshold masks; 1x1 heads (and, with
``supervise_single``, the per-slot outputs of the first two slots).
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.models.camera.lss import (
    create_frustum, gen_dx_bx, get_geometry, voxel_pooling_3d)
from airv2x_tpu_torch.models.fusion.bm2cp_flat import (
    ImgCamEncode, MultiModalFusion, atten_comm_fuse, fuse_ego_depth)
from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase


def bm2cp_voxel_pooling(geom, feats, dx, lo, nx):
    """point_pillar_bm2cp.voxel_pooling: the scatter-add of the lifted
    features into the (B, Z, Y, X, C) grid, Z kept; the cell index
    truncates toward zero (the JAX package's ``.astype(int32)``)."""
    return voxel_pooling_3d(geom, feats, dx, lo, nx)


class CameraGrid(torch.nn.Module):
    """The constants of BM2CP's camera branch for one ``img_params`` block:
    the frustum, the cell size ``dx`` and the grid's low corner ``lo``
    (non-persistent f32 buffers, out of the state_dict), and the depth-bin
    count the ``ImgCamEncode`` of that block needs."""

    def __init__(self, img: dict):
        super().__init__()
        grid = img["grid_conf"]
        dx, bx, self.nx = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
        frustum = create_frustum(img["data_aug_conf"]["final_dim"],
                                 int(img["img_downsample"]), grid["ddiscr"],
                                 grid["mode"])
        self.depth_bins = frustum.shape[0]
        self.register_buffer("frustum", torch.from_numpy(frustum), persistent=False)
        self.register_buffer("dx", torch.from_numpy(dx), persistent=False)
        self.register_buffer("lo", torch.from_numpy(bx - dx / 2.0), persistent=False)

    def lift(self, camencode, cam, depth):
        """The camera volume (N, Z, Y, X, C) of ``camencode`` on cam: imgs
        (N, Ncam, H, W, 3[+1]), intrinsics / rots / post_rots (N, Ncam, 3,
        3), trans / post_trans (N, Ncam, 3); depth (N, Ncam, H, W) bin
        levels, -1 where unobserved."""
        imgs = cam["imgs"]
        n, ncam = imgs.shape[:2]
        dtype = camencode.image_head.weight.dtype
        rgb = imgs.flatten(0, 1)[..., :3].permute(0, 3, 1, 2).to(dtype).contiguous(
            memory_format=torch.channels_last)
        lifted = camencode(rgb, depth.flatten(0, 1))
        lifted = lifted.unflatten(0, (n, ncam))  # (N, Ncam, fH, fW, D, C)
        geom = get_geometry(
            self.frustum.float(),
            *(cam[k].float() for k in ("rots", "trans", "intrinsics",
                                       "post_rots", "post_trans")))
        return bm2cp_voxel_pooling(geom.permute(0, 1, 3, 4, 2, 5), lifted,
                                   self.dx.float(), self.lo.float(), self.nx)


def composite_depth(depth_maps, agent_mask):
    """(B, L, [2,] Ncam, H, W) depth maps -> (B, L, Ncam, H, W): a two-view
    block is composited per camera (``fuse_ego_depth``)."""
    if depth_maps.dim() != 6:
        return depth_maps
    return torch.stack([fuse_ego_depth(depth_maps[:, :, :, c], agent_mask)
                        for c in range(depth_maps.shape[3])], dim=2)


class PointPillarBM2CP(PointPillarBase):
    """``point_pillar_bm2cp``: reads ``cam_vehicle`` with its
    ``depth_maps`` besides the points."""

    def __init__(self, args: dict):
        super().__init__(args)
        img = args["img_params"]
        self.cf = args["collaborative_fusion"]
        self.supervise_single = bool(args.get("supervise_single", False))
        self.cam_grid = CameraGrid(img)
        self.camencode = ImgCamEncode(self.cam_grid.depth_bins,
                                      int(img["bev_dim"]),
                                      int(img["img_downsample"]))
        self.fusion = MultiModalFusion(int(img["bev_dim"]))

    def modal_maps(self, batch):
        """The pillar and the camera volumes, fused: (fused (B*L, Y, X, C),
        threshold map (B*L, Y, X, 1), mask code (B*L, Y, X, 1))."""
        spatial = self.encode(batch)  # (B, L, Y, X, C)
        pc_voxel = spatial.flatten(0, 1)[:, None]  # Z = 1
        cam = {k: v.flatten(0, 1) for k, v in batch["cam_vehicle"].items()
               if k != "depth_maps"}
        depth = composite_depth(batch["cam_vehicle"]["depth_maps"],
                                batch["agent_mask"])
        img_voxel = self.cam_grid.lift(self.camencode, cam, depth.flatten(0, 1))
        return self.fusion(img_voxel, pc_voxel)

    def forward(self, batch):
        agent_mask = batch["agent_mask"]
        b, l = agent_mask.shape
        fused_2d, thres_map, mask_map = self.modal_maps(batch)
        x = fused_2d.permute(0, 3, 1, 2).to(self.compute_dtype)
        feats_2d, _ = self.backbone(x)
        if self.shrink_conv is not None:
            feats_2d = self.shrink_conv(feats_2d)
        psm_single = self.cls_head(feats_2d)
        conf = torch.sigmoid(psm_single).amax(1).unflatten(0, (b, l))
        thres = thres_map[..., 0].unflatten(0, (b, l))
        fused, rate = atten_comm_fuse(
            self.backbone, x, feats_2d, conf, thres, batch["pairwise_t_full"],
            agent_mask, mask_dtype=fused_2d.dtype,
            discrete_ratio=float(self.cf["voxel_size"][0]),
            downsample_rate=float(self.cf.get("downsample_rate", 1)),
            multi_scale=bool(self.cf.get("multi_scale", True)))
        if self.cf.get("multi_scale", True) and self.shrink_conv is not None:
            fused = self.shrink_conv(fused)
        out = self.heads(fused)
        out.update(comm_rate=rate, mask=mask_map)
        if self.supervise_single:
            single = self.heads(feats_2d)
            psm_s, rm_s = (single[k].unflatten(0, (b, l)) for k in ("psm", "rm"))
            out.update(psm_single_v=psm_s[:, 0], rm_single_v=rm_s[:, 0])
            if l > 1:
                out.update(psm_single_i=psm_s[:, 1], rm_single_i=rm_s[:, 1])
        return out
