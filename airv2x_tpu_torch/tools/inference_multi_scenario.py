"""Per-scenario AP evaluation over the on-disk dataset (counterpart of
airv2x_tpu/tools/inference_multi_scenario.py).

    python -m airv2x_tpu_torch.tools.inference_multi_scenario
        --model_dir <run dir> [--test_dir dataset/airv2x/test] [--epoch N]
        [--num_scenes N] [--seed N] [--device cuda|cpu]

Buckets the AP statistics by scenario directory and reports AP@0.3 / 0.5 /
0.7 per scenario and COMBINED, with the mean communication rate, appending
the lines to ``results.txt`` in the run dir (``name: {python dict}``, the
format the AP gates parse). Without the test dir (``--test_dir``, else the
config's ``test_dir``) it evaluates synthetic scenes in four buckets and
says so. ``--track``, ``--save_vis`` and ``--vis_3d`` are not ported and
raise.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from airv2x_tpu_torch.eval.ap import (
    IOU_THRESHOLDS, accumulate_scene, eval_final_results, new_result_stat)
from airv2x_tpu_torch.tools.inference import (
    det_step, load_run, report_time, scenes)
from airv2x_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="per-scenario AP evaluation")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--test_dir", default="")
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--num_scenes", type=int, default=16, help="synthetic fallback")
    p.add_argument("--save_vis", action="store_true")
    p.add_argument("--track", action="store_true")
    p.add_argument("--vis_3d", action="store_true")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def evaluate(hypes, model, device, test_dir: str, num_scenes: int, seed: int):
    """(table, ms per scene): {scenario or "COMBINED": AP dict} of ``model``
    on the test dir's samples (else synthetic scenes), COMBINED with the
    mean communication rate."""
    step = det_step(hypes, model, device)
    source, it = scenes(hypes, model.layout, test_dir, num_scenes, seed)
    print(source)

    per_scenario, rates = {}, []
    t0 = time.perf_counter()
    for scen, scene, gt in it:
        d = step(scene, gt)
        rates.append(d.rate)
        accumulate_scene(d.corners, d.scores, d.gt_corners,
                         per_scenario.setdefault(scen, new_result_stat()))
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
    return table, ms


def main(argv=None) -> dict:
    """Run the evaluation; returns {scenario or "COMBINED": AP dict} and the
    host ms per scene under "ms_per_scene"."""
    opt = parse_args(argv)
    if opt.track or opt.save_vis or opt.vis_3d:
        raise NotImplementedError(
            "--track, --save_vis and --vis_3d are not ported")
    dev = resolve_device(opt.device)
    hypes, model, _ = load_run(opt.model_dir, dev, opt.epoch)
    table, ms = evaluate(hypes, model, dev, opt.test_dir or hypes.get("test_dir", ""),
                         opt.num_scenes, opt.seed)
    lines = [f"{scen}: {res}" for scen, res in table.items()]
    for line in lines:
        print(line)
    with open(os.path.join(opt.model_dir, "results.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    return dict(table, ms_per_scene=ms)


if __name__ == "__main__":
    main()
