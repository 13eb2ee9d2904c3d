"""Bounded smoke inference: the first N samples, each rendered in BEV and
3-D, then the AP table (counterpart of airv2x_tpu/tools/inference_tiny.py).

    python -m airv2x_tpu_torch.tools.inference_tiny --model_dir <run dir>
        [--test_dir dataset/airv2x/test] [--max_samples 150] [--epoch N]
        [--num_scenes 8] [--seed N] [--device cuda|cpu]

Evaluates at most ``--max_samples`` samples of the split (else
``--num_scenes`` synthetic ``make_scene`` scenes), writes
``vis/bev_{i:05d}.png`` and ``vis/3d_{i:05d}.png`` per frame in the run
dir, and appends the AP line to ``results.txt`` as ``tiny: ...``. A quick
check that a run dir is sane without walking the whole split.
"""

from __future__ import annotations

import argparse
import os
import time

from airv2x_tpu_torch.eval.ap import accumulate_scene, eval_final_results, new_result_stat
from airv2x_tpu_torch.tools.inference import det_step, load_run, report_time, scenes
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.visualization.bev_canvas import visualize
from airv2x_tpu_torch.visualization.canvas_3d import Canvas3D


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="airv2x_tpu_torch tiny inference")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--test_dir", default="")
    p.add_argument("--epoch", type=int, default=0, help="0 = best epoch")
    p.add_argument("--max_samples", type=int, default=150,
                   help="evaluate only the first N samples")
    p.add_argument("--num_scenes", type=int, default=8,
                   help="synthetic fallback scene count")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run it; returns the AP dict (and ms per scene)."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, _ = load_run(opt.model_dir, dev, opt.epoch)
    lidar_range = hypes["preprocess"]["cav_lidar_range"]
    step = det_step(hypes, model, dev)
    source, it = scenes(hypes, model.layout, opt.test_dir or hypes.get("test_dir", ""),
                        min(opt.num_scenes, opt.max_samples), opt.seed,
                        max_samples=opt.max_samples)
    print(source)

    vis_dir = os.path.join(opt.model_dir, "vis")
    os.makedirs(vis_dir, exist_ok=True)
    stat = new_result_stat()
    t0, n = time.perf_counter(), 0
    for i, (_, scene, gt) in enumerate(it):
        d = step(scene, gt)
        accumulate_scene(d.corners, d.scores, d.gt_corners, stat)
        det_c3, gt_c3 = d.corners3d.cpu().numpy(), d.gt_corners3d.cpu().numpy()
        pts = scene["points"][scene["points_mask"]].reshape(-1, 4)
        visualize(det_c3, gt_c3, pts, lidar_range,
                  save_path=os.path.join(vis_dir, f"bev_{i:05d}.png"))
        c3d = Canvas3D()
        c3d.draw_points(pts[:, :3], (160, 160, 160))
        if det_c3.size:
            c3d.draw_boxes(det_c3, (255, 60, 60))
        if gt_c3.size:
            c3d.draw_boxes(gt_c3, (60, 255, 60))
        c3d.save(os.path.join(vis_dir, f"3d_{i:05d}.png"))
        n += 1
    ms = report_time(n, t0, dev)

    res = eval_final_results(stat)
    msg = (f"AP@0.3: {res['ap_30']:.4f} AP@0.5: {res['ap_50']:.4f} "
           f"AP@0.7: {res['ap_70']:.4f}")
    print(msg)
    with open(os.path.join(opt.model_dir, "results.txt"), "a") as f:
        f.write("tiny: " + msg + "\n")
    return dict(res, ms_per_scene=ms)


if __name__ == "__main__":
    main()
