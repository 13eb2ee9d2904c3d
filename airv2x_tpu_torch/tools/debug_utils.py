"""Label-pipeline round trip: the gt label map through the decode, held to
the gt boxes (counterpart of airv2x_tpu/tools/debug_utils.py).

    python -m airv2x_tpu_torch.tools.debug_utils --hypes_yaml <cfg>
        [--model_dir <run dir>] [--num_scenes 4] [--out vis.png] [--seed 0]
        [--device cuda|cpu]

Each ``make_scene`` scene's anchor targets (``ops/anchors.py:assign_targets``)
go through ``decode_detections`` as if they were the model's output: the
{0, 1} positive map as a +-10 logit (less a 1e-6 ramp per anchor, so that
two equal-score duplicates of one gt cannot both survive NMS), the
regression targets as they are. Only the gts decode can recover are scored:
a gt overlapping another above the NMS threshold cannot survive, nor one
partly outside the range (a detection of such a gt is dropped too). The
tool prints the AP and the worst mean corner error, and fails unless the
AP@0.7 is at least 0.99; ``--out`` renders the last scene's BEV overlay.
The IoUs (NMS, the gt overlaps, the AP) run on the device: K2 on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.eval.ap import accumulate_scene, eval_final_results, new_result_stat
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.anchors import (
    anchor_standup_boxes, assign_targets, generate_anchor_grid)
from airv2x_tpu_torch.ops.quad_iou import quad_iou
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.visualization.bev_canvas import visualize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="label pipeline round trip")
    p.add_argument("--hypes_yaml", default="")
    p.add_argument("--model_dir", default="",
                   help="read config.yaml from a run dir instead")
    p.add_argument("--num_scenes", type=int, default=4)
    p.add_argument("--out", default="", help="BEV overlay png path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the round trip; returns the AP dict with the worst mean corner
    error (``worst_corner_m``). Raises SystemExit if AP@0.7 < 0.99."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml or None, opt.model_dir or None)
    layout = SlotLayout.from_args(hypes["model"]["args"])
    anchors_np = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    anchors = torch.from_numpy(anchors_np).to(dev)
    standup = torch.from_numpy(anchor_standup_boxes(anchors_np)).to(dev)
    lidar_range = hypes["preprocess"]["cav_lidar_range"]
    lr = torch.tensor(lidar_range, dtype=torch.float32, device=dev)
    tgt = hypes["postprocess"]["target_args"]
    nms_thresh = float(hypes["postprocess"]["nms_thresh"])

    rng = np.random.default_rng(opt.seed)
    stat = new_result_stat()
    worst = 0.0
    last = None
    for _ in range(opt.num_scenes):
        scene, gt = make_scene(rng, layout, points_per_agent=2048,
                               lidar_range=lidar_range)
        t = assign_targets(
            torch.from_numpy(gt["boxes"]).to(dev),
            torch.from_numpy(gt["mask"].astype(bool)).to(dev),
            torch.from_numpy(np.asarray(gt["classes"], np.int32)).to(dev),
            anchors, standup, pos_threshold=float(tgt["pos_threshold"]),
            neg_threshold=float(tgt["neg_threshold"]))
        ramp = torch.arange(t.pos_equal_one.numel(), dtype=torch.float32,
                            device=dev).reshape(t.pos_equal_one.shape) * 1e-6
        obj_logits = t.pos_equal_one * 20.0 - 10.0 - ramp
        det = decode_detections(
            obj_logits, t.targets, obj_logits, anchors, torch.eye(4, device=dev),
            lr, num_class=1, obj_threshold=0.5, nms_thresh=nms_thresh,
            top_k=int(hypes["postprocess"].get("nms_top_k", 512)))
        keep = det.mask
        det_c = det.corners[keep]
        det_s = det.scores[keep].cpu().numpy()
        gm = gt["mask"].astype(bool)
        gt_c = geo.boxes_to_corners_3d(torch.from_numpy(gt["boxes"][gm]).to(dev),
                                       order="hwl")
        bev = gt_c[:, :4, :2].contiguous()
        giou = quad_iou(bev, bev).cpu().numpy()
        np.fill_diagonal(giou, 0.0)
        separate = giou.max(axis=1, initial=0.0) <= nms_thresh
        in_range = geo.mask_boxes_in_range_bev(gt_c, lr).cpu().numpy()
        decodable = torch.from_numpy(separate & in_range).to(dev)
        dropped = gt_c[~decodable]
        gt_c = gt_c[decodable]
        if len(dropped) and len(det_c):
            diou = quad_iou(det_c[:, :4, :2].contiguous(),
                            dropped[:, :4, :2].contiguous()).cpu().numpy()
            det_keep = diou.max(axis=1) < 0.3
            det_c = det_c[torch.from_numpy(det_keep).to(dev)]
            det_s = det_s[det_keep]
        accumulate_scene(det_c[:, :4, :2], det_s, gt_c[:, :4, :2], stat)
        if det_c.numel() and gt_c.numel():
            d = torch.linalg.vector_norm(
                det_c[:, None, :4, :2] - gt_c[None, :, :4, :2], dim=-1).mean(-1)
            worst = max(worst, float(d.amin(dim=1).max()))
        last = (det_c.cpu().numpy(), gt_c.cpu().numpy(), scene)

    res = eval_final_results(stat)
    print(f"label-map round trip: AP@0.3/0.5/0.7 = "
          f"{res['ap_30']:.3f}/{res['ap_50']:.3f}/{res['ap_70']:.3f}, "
          f"worst mean-corner error {worst:.4f} m")
    if res["ap_70"] < 0.99:
        raise SystemExit("label pipeline round trip FAILED (AP@0.7 < 0.99)")

    if opt.out and last is not None:
        det_c, gt_c, scene = last
        pts = scene["points"][scene["points_mask"]].reshape(-1, 4)
        visualize(det_c, gt_c, pts, lidar_range, save_path=opt.out)
        print(f"wrote {opt.out}")
    return dict(res, worst_corner_m=worst)


if __name__ == "__main__":
    main()
