"""Distance ablation (counterpart of airv2x_tpu/tools/abl_object_dist.py).

    python -m airv2x_tpu_torch.tools.abl_object_dist --model_dir <run dir>
        [--range "X,Y"] [--buckets 0,30,50,1e9] [--hypes_yaml cfg]
        [--epoch N] [--num_scenes N] [--obj_threshold x] [--seed N]
        [--device cuda|cpu]

``--range "X,Y"`` restricts the evaluation range to [-X, X] x [-Y, Y]
(the config's ``cav_lidar_range`` and anchor range are rewritten, so the
model runs on the cropped grid and detections and gt outside it drop out).
Beside the overall AP it reports the AP per ego-distance bucket of the
box centres (0-30 m, 30-50 m, 50 m+ by default), and writes the table to
``abl_object_dist.yaml`` in the run dir. The scenes are ``make_scene``'s
(8 objects), seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.eval.ap import accumulate_scene, eval_final_results, new_result_stat
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.tools.inference import det_step, report_time, scenes
from airv2x_tpu_torch.utils.checkpoint import find_best_epoch, load_model_weights
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import cast_weights_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="distance-ablation eval")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--hypes_yaml", default=None)
    p.add_argument("--num_scenes", type=int, default=16)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--obj_threshold", type=float, default=0.0)
    p.add_argument("--range", default=None,
                   help='"X,Y": restrict eval range to [-X,X]x[-Y,Y]')
    p.add_argument("--buckets", default="0,30,50,1e9",
                   help="ego-distance bucket edges in meters")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _center_dist(corners: np.ndarray) -> np.ndarray:
    """(N, 4, 2) BEV quads -> their centres' distance from the ego."""
    return np.linalg.norm(corners.mean(axis=1)[:, :2], axis=1)


def main(argv=None) -> dict:
    """Run the ablation; returns {"overall" or bucket: AP dict}."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml or None, opt.model_dir)
    if opt.range:
        x_r, y_r = (float(v) for v in opt.range.split(","))
        old = hypes["preprocess"]["cav_lidar_range"]
        new_range = [-x_r, -y_r, old[2], x_r, y_r, old[5]]
        hypes["preprocess"]["cav_lidar_range"] = new_range
        hypes["postprocess"]["anchor_args"]["cav_lidar_range"] = new_range
        print(f"[abl] restricted eval range to {new_range}")

    model = build_model(hypes, device=dev)
    epoch = opt.epoch or find_best_epoch(opt.model_dir)
    if epoch:
        load_model_weights(opt.model_dir, epoch, model)
        print(f"loaded epoch {epoch}")
    else:
        print("WARNING: no checkpoint found, evaluating random init")
    if compute_dtype(hypes) == torch.bfloat16:
        cast_weights_(model, torch.bfloat16)

    edges = [float(v) for v in opt.buckets.split(",")]
    buckets = list(zip(edges[:-1], edges[1:]))
    step = det_step(hypes, model, dev, opt.obj_threshold)
    _, it = scenes(hypes, model.layout, "", opt.num_scenes + 1, opt.seed,
                   num_objects=8)
    next(it)  # the JAX tool's first scene only initialises its model

    stats = {b: new_result_stat() for b in buckets}
    overall = new_result_stat()
    t0 = time.perf_counter()
    for _, scene, gt in it:
        d = step(scene, gt)
        accumulate_scene(d.corners, d.scores, d.gt_corners, overall)
        det_c, gt_c = d.corners.cpu().numpy(), d.gt_corners.cpu().numpy()
        dd, gd = _center_dist(det_c), _center_dist(gt_c)
        for b in buckets:
            dsel = (dd >= b[0]) & (dd < b[1])
            gsel = (gd >= b[0]) & (gd < b[1])
            accumulate_scene(d.corners[torch.from_numpy(dsel).to(dev)],
                             d.scores[dsel], d.gt_corners[torch.from_numpy(gsel).to(dev)],
                             stats[b])
    ms = report_time(opt.num_scenes, t0, dev)

    res = {"overall": eval_final_results(overall)}
    lines = ["overall  AP@0.3 {ap_30:.4f}  AP@0.5 {ap_50:.4f}  AP@0.7 "
             "{ap_70:.4f}".format(**res["overall"])]
    for b in buckets:
        r = eval_final_results(stats[b])
        key = f"{b[0]:g}-{b[1]:g}m" if b[1] < 1e8 else f"{b[0]:g}m+"
        res[key] = r
        lines.append(f"{key:8s} AP@0.3 {r['ap_30']:.4f}  AP@0.5 {r['ap_50']:.4f}"
                     f"  AP@0.7 {r['ap_70']:.4f}  (gt={stats[b][0.3]['gt']})")
    print("\n".join(lines))
    save_yaml(res, os.path.join(opt.model_dir, "abl_object_dist.yaml"))
    return dict(res, ms_per_scene=ms)


if __name__ == "__main__":
    main()
