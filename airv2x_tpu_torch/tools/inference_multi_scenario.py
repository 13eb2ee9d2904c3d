"""Per-scenario AP evaluation over the on-disk dataset (counterpart of
airv2x_tpu/tools/inference_multi_scenario.py).

    python -m airv2x_tpu_torch.tools.inference_multi_scenario
        --model_dir <run dir> [--test_dir dataset/airv2x/test] [--epoch N]
        [--num_scenes N] [--seed N] [--track] [--save_vis] [--vis_3d]
        [--device cuda|cpu]

Buckets the AP statistics by scenario directory and reports AP@0.3 / 0.5 /
0.7 per scenario and COMBINED, with the mean communication rate, appending
the lines to ``results.txt`` in the run dir (``name: {python dict}``, the
format the AP gates parse). Without the test dir (``--test_dir``, else the
config's ``test_dir``) it evaluates synthetic scenes in four buckets and
says so.

``--track`` associates each scenario's detections across its frames (one
``models/tracking.py:Tracker`` per scenario, on the boxes' normalised
geometry at similarity 0.9: ``TrackingHead`` pools the whole map, so it
gives every detection of a frame one embedding) and writes each frame's
track ids to ``tracks.txt`` in the run dir. ``--save_vis`` renders the
first 8 frames' BEV views to ``vis/frame_{i:04d}.png`` (points, gt boxes,
detections), and with ``--vis_3d`` their perspective views to
``vis/frame3d_{i:04d}.png`` (drawn in numpy: the JAX tool draws with
OpenCV where it is installed).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from airv2x_tpu_torch.eval.ap import (
    IOU_THRESHOLDS, accumulate_scene, eval_final_results, new_result_stat)
from airv2x_tpu_torch.models.tracking import Tracker, geometry_embedding
from airv2x_tpu_torch.tools.inference import (
    det_step, load_run, report_time, scenes)
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.visualization.bev_canvas import visualize
from airv2x_tpu_torch.visualization.canvas_3d import Canvas3D


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-scenario AP evaluation")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--test_dir", default="")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--num_scenes", type=int, default=16, help="synthetic fallback")
    p.add_argument("--save_vis", action="store_true",
                   help="render the first 8 frames' BEV views to vis/")
    p.add_argument("--track", action="store_true",
                   help="associate detections across frames (Hungarian "
                   "tracker), writing per-frame track ids to tracks.txt")
    p.add_argument("--vis_3d", action="store_true",
                   help="also render a perspective 3D view per frame")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def evaluate(hypes, model, device, test_dir: str, num_scenes: int, seed: int,
             track: bool = False, vis_dir: str = "", vis_3d: bool = False):
    """(table, ms per scene, track lines): {scenario or "COMBINED": AP dict}
    of ``model`` on the test dir's samples (else synthetic scenes),
    COMBINED with the mean communication rate; with ``track``, one line per
    frame of each detection's track id and position; with ``vis_dir``, the
    first 8 frames' renders there."""
    step = det_step(hypes, model, device)
    source, it = scenes(hypes, model.layout, test_dir, num_scenes, seed)
    print(source)
    lidar_range = hypes["preprocess"]["cav_lidar_range"]

    per_scenario, rates, trackers, track_lines = {}, [], {}, []
    t0 = time.perf_counter()
    for i, (scen, scene, gt) in enumerate(it):
        d = step(scene, gt)
        rates.append(d.rate)
        accumulate_scene(d.corners, d.scores, d.gt_corners,
                         per_scenario.setdefault(scen, new_result_stat()))
        if track:
            tracker = trackers.setdefault(scen, Tracker(sim_threshold=0.9))
            tids = tracker.update(d.boxes, geometry_embedding(d.boxes, lidar_range))
            track_lines.append(f"{scen} frame {i}: " + " ".join(
                f"id={tid} xy=({b[0]:.1f},{b[1]:.1f})"
                for tid, b in zip(tids, d.boxes)))
        if vis_dir and i < 8:
            render_frame(scene, d, lidar_range, vis_dir, i, vis_3d)
    ms = report_time(len(rates), t0, device)

    combined = new_result_stat()
    table = {}
    for scen, stat in sorted(per_scenario.items()):
        table[scen] = eval_final_results(stat)
        for t in IOU_THRESHOLDS:
            for k in ("tp", "fp", "score"):
                combined[t][k] += stat[t][k]
            combined[t]["gt"] += stat[t]["gt"]
    table["COMBINED"] = eval_final_results(combined)
    table["COMBINED"]["comm_rate"] = float(np.mean(rates))
    return table, ms, track_lines


def render_frame(scene, d, lidar_range, vis_dir: str, i: int, vis_3d: bool):
    """Frame ``i``'s BEV render (``frame_{i:04d}.png``: the scene's points,
    the gt and the kept boxes) and, with ``vis_3d``, its perspective render
    (``frame3d_{i:04d}.png``)."""
    pts = scene["points"][scene["points_mask"]].reshape(-1, 4)
    visualize(d.corners.cpu().numpy(), d.gt_corners.cpu().numpy(), pts,
              lidar_range, save_path=os.path.join(vis_dir, f"frame_{i:04d}.png"))
    if vis_3d:
        c3d = Canvas3D()
        c3d.draw_points(pts[:, :3], (160, 160, 160))
        if d.corners3d.numel():
            c3d.draw_boxes(d.corners3d.cpu().numpy(), (255, 60, 60))
        if d.gt_corners3d.numel():
            c3d.draw_boxes(d.gt_corners3d.cpu().numpy(), (60, 255, 60))
        c3d.save(os.path.join(vis_dir, f"frame3d_{i:04d}.png"))


def main(argv=None) -> dict:
    """Run the evaluation; returns {scenario or "COMBINED": AP dict} and the
    host ms per scene under "ms_per_scene"."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, _ = load_run(opt.model_dir, dev, opt.epoch)
    vis_dir = os.path.join(opt.model_dir, "vis") if opt.save_vis else ""
    if vis_dir:
        os.makedirs(vis_dir, exist_ok=True)
    table, ms, track_lines = evaluate(
        hypes, model, dev, opt.test_dir or hypes.get("test_dir", ""),
        opt.num_scenes, opt.seed, track=opt.track, vis_dir=vis_dir,
        vis_3d=opt.vis_3d)
    lines = [f"{scen}: {res}" for scen, res in table.items()]
    for line in lines:
        print(line)
    with open(os.path.join(opt.model_dir, "results.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    if track_lines:
        with open(os.path.join(opt.model_dir, "tracks.txt"), "w") as f:
            f.write("\n".join(track_lines) + "\n")
        print(f"wrote {len(track_lines)} tracked frames to tracks.txt")
    return dict(table, ms_per_scene=ms)


if __name__ == "__main__":
    main()
