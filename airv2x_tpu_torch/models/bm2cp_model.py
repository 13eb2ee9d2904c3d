"""AirV2X BM2CP (counterpart of airv2x_tpu/models/bm2cp_model.py:
``BM2CPAgentEncoder``, ``BM2CPDroneEncoder`` and ``Airv2xBM2CP``, the
``airv2x_bm2cp`` det and seg configs).

  * ``veh_model`` / ``rsu_model``: the classic pillar path on the shared ego
    grid (``pillarize`` -> the type's ``PillarVFE`` -> scatter; no K1), a
    volume with Z = 1; the camera lift (``ImgCamEncode``, the observed
    LiDAR depth one-hot where a bin is observed) pooled without
    collapsing Z; ``MultiModalFusion`` of the two volumes;
  * ``drone_model``: the LSS camera encoder, then ``MultiModalFusion``
    against the reference's all-zero mock LiDAR volume, so every drone
    pixel is camera-routed and its threshold is 0.5;
  * the ResNet BEV backbone (no K4), the shrink, the heads;
  * AttenComm (``atten_comm_fuse``): confidence against threshold-map
    masks with the even-slot always-send quirk, then per-level pixel-wise
    agent self-attention over the backbone's stages re-run on the
    pre-backbone maps.

The outputs are the heads' (NHWC), ``comm_rate`` and ``mask`` (each slot's
modal routing code, (B, L, Y, X, 1)), as in the JAX package; the depth
logits are not returned.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.base import AGENT_TYPES, SlotLayout
from airv2x_tpu_torch.models.camera.lss import LSSCameraEncoder
from airv2x_tpu_torch.models.fusion.bm2cp_flat import (
    ImgCamEncode, MultiModalFusion, atten_comm_fuse)
from airv2x_tpu_torch.models.heads import BevSegHead, DetectionHeads
from airv2x_tpu_torch.models.nn import DownsampleConv
from airv2x_tpu_torch.models.pillar_vfe import PillarVFE, pillar_bev
from airv2x_tpu_torch.models.point_pillar_bm2cp_model import (
    CameraGrid, composite_depth)
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from airv2x_tpu_torch.ops.voxelize import pillar_kwargs, pillarize_batch


class BM2CPAgentEncoder(nn.Module):
    """sensor_blocks.LidarCamBM2CPEncoder for one agent type."""

    def __init__(self, img_params: dict, pc_params: dict, preprocess: dict):
        super().__init__()
        self.pillar_kw = pillar_kwargs(preprocess)
        pv = pc_params["pillar_vfe"]
        self.vfe = PillarVFE(num_filters=pv["num_filters"],
                             voxel_size=pc_params["voxel_size"],
                             lidar_range=pc_params["lidar_range"],
                             use_norm=pv["use_norm"],
                             with_distance=pv["with_distance"],
                             use_absolute_xyz=pv["use_absolute_xyz"])
        self.cam_grid = CameraGrid(img_params)
        self.camencode = ImgCamEncode(self.cam_grid.depth_bins,
                                      int(img_params["bev_dim"]),
                                      int(img_params["img_downsample"]))
        self.intra_fusion = MultiModalFusion(int(img_params["bev_dim"]))

    def forward(self, pts, pts_mask, cam, depth):
        """pts (N, P, 4) ego frame, pts_mask (N, P); cam the type's camera
        block (N, Ncam, ...); depth (N, Ncam, H, W) bin levels, -1 where
        unobserved. Returns (fused (N, Y, X, C * Z), threshold map
        (N, Y, X, 1), mask code (N, Y, X, 1))."""
        bev = pillar_bev(self.vfe, pillarize_batch(pts, pts_mask, **self.pillar_kw),
                         self.pillar_kw["grid_size"])
        img_voxel = self.cam_grid.lift(self.camencode, cam, depth)
        return self.intra_fusion(img_voxel, bev[:, None])


class BM2CPDroneEncoder(nn.Module):
    """sensor_blocks.LiftSplatShootEncoder: the camera-only LSS encoder,
    fused against the all-zero mock LiDAR volume."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.lss = LSSCameraEncoder(cfg)
        self.intra_fusion = MultiModalFusion(int(cfg["bev_dim"]))

    def forward(self, cam):
        x_3d = self.lss(cam)[:, None]  # (N, 1, Y, X, C)
        return self.intra_fusion(x_3d, torch.zeros_like(x_3d))


class Airv2xBM2CP(nn.Module):
    """airv2x_bm2cp.py Airv2xBM2CP, det or seg by the config's ``task``."""

    def __init__(self, args: dict):
        super().__init__()
        self.layout = SlotLayout.from_args(args)
        collab = list(args["collaborators"])
        pre = args["preprocess"]
        self.encoders = {}
        for t, attr in zip(AGENT_TYPES, ("veh_model", "rsu_model", "drone_model")):
            if t not in collab or not self.layout.counts[AGENT_TYPES.index(t)]:
                continue
            enc = (BM2CPDroneEncoder(args[t]) if t == "drone" else
                   BM2CPAgentEncoder(args[t]["img_params"], args[t]["pc_params"],
                                     pre))
            self.add_module(attr, enc)
            self.encoders[t] = attr
        mod = args["modality_fusion"]
        bb = mod["bev_backbone"]
        self.backbone = ResNetBEVBackbone(
            layer_nums=bb["layer_nums"], layer_strides=bb["layer_strides"],
            num_filters=bb["num_filters"],
            upsample_strides=bb.get("upsample_strides", ()),
            num_upsample_filters=bb.get("num_upsample_filter", ()),
            inplanes=int(args["vehicle"]["pc_params"]["point_pillar_scatter"]
                         ["num_features"]))
        head_in = self.backbone.out_channels
        shrink = mod.get("shrink_header", {})
        self.shrink_conv = None
        if shrink.get("use"):
            self.shrink_conv = DownsampleConv(
                head_in, dims=shrink["dim"], kernels=shrink["kernal_size"],
                strides=shrink["stride"], paddings=shrink.get("padding"))
            head_in = self.shrink_conv.out_channels
        if int(mod.get("compression", 0)) > 0:
            raise NotImplementedError("NaiveCompressor is not ported")
        self.cf = args["collaborative_fusion"]
        self.task = args.get("task", "det")
        if self.task == "det":
            if not args.get("obj_head", True):
                raise NotImplementedError("decode needs the objectness head")
            self.heads = DetectionHeads(head_in, anchor_number=args["anchor_number"],
                                        num_class=args["num_class"])
        else:
            self.seg_head = BevSegHead(
                head_in, seg_branch=args["seg_branch"], seg_hw=args["seg_hw"],
                dynamic_class=args["dynamic_class"],
                static_class=args["static_class"], seg_res=args["seg_res"],
                cav_range=args["cav_range"])

    @property
    def compute_dtype(self) -> torch.dtype:
        """The dtype the convolutions run in (bf16 after the serving cast)."""
        return self.backbone.stages[0].blocks[0].conv0.weight.dtype

    def encode_agents(self, batch):
        """The per-type encoders -> (fused maps (B, L, Y, X, C), threshold
        maps (B, L, Y, X, 1), mask codes (B, L, Y, X, 1)) over the slots."""
        b = batch["points"].shape[0]
        feats, thres, masks = [], [], []
        for t in AGENT_TYPES:
            if t not in self.encoders:
                continue
            sl = self.layout.slots(t)
            enc = self.get_submodule(self.encoders[t])
            block = batch[f"cam_{t}"]
            cam = {k: v[:, sl].flatten(0, 1) for k, v in block.items()
                   if k != "depth_maps"}
            if t == "drone":
                out = enc(cam)
            else:
                depth = composite_depth(block["depth_maps"], batch["agent_mask"])
                out = enc(batch["points"][:, sl].flatten(0, 1),
                          batch["points_mask"][:, sl].flatten(0, 1), cam,
                          depth[:, sl].flatten(0, 1))
            for acc, v in zip((feats, thres, masks), out):
                acc.append(v.unflatten(0, (b, sl.stop - sl.start)))
        x = torch.cat(feats, dim=1)
        x = x * batch["agent_mask"][:, :, None, None, None].to(x.dtype)
        return x, torch.cat(thres, dim=1), torch.cat(masks, dim=1)

    def forward(self, batch):
        x, thres, mask = self.encode_agents(batch)
        b, l = x.shape[:2]
        xb = x.flatten(0, 1).permute(0, 3, 1, 2).to(self.compute_dtype)
        f2d, _ = self.backbone(xb)
        if self.shrink_conv is not None:
            f2d = self.shrink_conv(f2d)
        conf = (self.heads.cls_head(f2d) if self.task == "det"
                else self.seg_head.crop(f2d))
        conf = torch.sigmoid(conf.float()).amax(1).unflatten(0, (b, l))
        fused, rate = atten_comm_fuse(
            self.backbone, xb, f2d, conf, thres[..., 0], batch["pairwise_t_full"],
            batch["agent_mask"], mask_dtype=x.dtype,
            discrete_ratio=float(self.cf["voxel_size"][0]),
            downsample_rate=float(self.cf.get("downsample_rate", 1)),
            multi_scale=bool(self.cf.get("multi_scale", True)))
        if self.cf.get("multi_scale", True) and self.shrink_conv is not None:
            fused = self.shrink_conv(fused)
        if self.task == "det":
            fused = fused.to(self.heads.cls_head.weight.dtype)
            out = {k: v.permute(0, 2, 3, 1) for k, v in self.heads(fused).items()}
        else:
            out = self.seg_head(fused.to(self.compute_dtype))
        out.update(comm_rate=rate, mask=mask)
        return out
