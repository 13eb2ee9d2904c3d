"""Pose-noise robustness sweep (counterpart of
airv2x_tpu/tools/inference_w_noise.py).

    python -m airv2x_tpu_torch.tools.inference_w_noise --model_dir <run dir>
        [--noise_levels 0 0.2 0.4 0.6] [--epoch N] [--num_scenes N]
        [--seed N] [--device cuda|cpu]

For each noise level (a standard deviation, metres for x / y and degrees
for the yaw), every live non-ego agent's cloud is moved by a noisy pose
delta (``utils/transforms.py:add_pose_noise`` of the zero pose): under
``proj_first`` the localisation error lands in the points. The AP at IoU
0.3 / 0.5 / 0.7 of each level goes to ``noise_sweep.json`` in the run dir.
Every level replays the same ``make_scene`` scenes (the generator is
re-seeded with ``--seed``; the noise draws follow each scene's draws in
agent order, as in the JAX tool, so both packages see the same clouds).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.eval.ap import accumulate_scene, eval_final_results, new_result_stat
from airv2x_tpu_torch.tools.inference import det_step, load_run, report_time
from airv2x_tpu_torch.utils import transforms as tf
from airv2x_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pose-noise robustness sweep")
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--num_scenes", type=int, default=16)
    p.add_argument("--noise_levels", type=float, nargs="+",
                   default=[0.0, 0.2, 0.4, 0.6])
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def noisy_scenes(hypes, layout, num_scenes: int, seed: int, std: float):
    """``num_scenes`` ``make_scene`` scenes, each live non-ego agent's
    points moved by a pose delta drawn at ``std`` from the same generator."""
    rng = np.random.default_rng(seed)
    for _ in range(num_scenes):
        scene, gt = make_scene(
            rng, layout,
            points_per_agent=int(hypes["preprocess"].get("max_points", 8192)),
            lidar_range=hypes["preprocess"]["cav_lidar_range"])
        for slot in range(1, layout.total):
            if not scene["agent_mask"][slot]:
                continue
            noisy = tf.add_pose_noise(np.zeros(6), rng, xyz_std=std, ryp_std=std)
            T = tf.pose_to_world(noisy).astype(np.float32)
            scene["points"][slot] = tf.transform_points(
                scene["points"][slot], T).astype(np.float32)
        yield scene, gt


def main(argv=None) -> dict:
    """Run the sweep; returns {noise level: AP dict} (and ms per scene)."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, _ = load_run(opt.model_dir, dev, opt.epoch)
    step = det_step(hypes, model, dev)

    results = {}
    t0, n = time.perf_counter(), 0
    for std in opt.noise_levels:
        stat = new_result_stat()
        for scene, gt in noisy_scenes(hypes, model.layout, opt.num_scenes,
                                      opt.seed, std):
            d = step(scene, gt)
            accumulate_scene(d.corners, d.scores, d.gt_corners, stat)
            n += 1
        results[std] = eval_final_results(stat)
        print(f"noise std {std}: {results[std]}")
    ms = report_time(n, t0, dev)

    with open(os.path.join(opt.model_dir, "noise_sweep.json"), "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f, indent=2)
    return dict(results, ms_per_scene=ms)


if __name__ == "__main__":
    main()
