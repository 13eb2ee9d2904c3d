"""Multiclass mAP evaluation CLI (counterpart of
airv2x_tpu/tools/inference_airv2x.py).

    python -m airv2x_tpu_torch.tools.inference_airv2x --model_dir <run dir>
        [--test_dir dataset/airv2x/test] [--epoch N] [--num_scenes N]
        [--max_samples N] [--seed N] [--device cuda|cpu]

Per-class greedy TP / FP matching at IoU 0.3 / 0.5 / 0.7, the per-class AP
table and the mAP over the classes present, with the mean communication
rate; the on-disk dataset when present, synthetic scenes otherwise. Appends
to ``results_multiclass.txt`` and writes ``eval_multiclass_epoch{N}.yaml``
in the run dir.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from airv2x_tpu_torch.config import save_yaml
from airv2x_tpu_torch.eval.ap import (
    IOU_THRESHOLDS, accumulate_multiclass, eval_multiclass_results,
    new_multiclass_stat)
from airv2x_tpu_torch.tools.inference import (
    det_step, load_run, report_time, scenes)
from airv2x_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="multiclass mAP evaluation")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--test_dir", default="")
    p.add_argument("--epoch", type=int, default=0, help="0 = best epoch")
    p.add_argument("--num_scenes", type=int, default=32, help="synthetic fallback")
    p.add_argument("--max_samples", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the evaluation; returns the result dict (and "ms_per_scene")."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, epoch = load_run(opt.model_dir, dev, opt.epoch)
    num_class = int(hypes["num_class"])
    step = det_step(hypes, model, dev)
    source, it = scenes(hypes, model.layout,
                        opt.test_dir or hypes.get("test_dir", ""),
                        opt.num_scenes, opt.seed, max_samples=opt.max_samples)
    print(source)

    stat = new_multiclass_stat(num_class)
    rates = []
    t0 = time.perf_counter()
    for _, scene, gt in it:
        d = step(scene, gt)
        rates.append(d.rate)
        accumulate_multiclass(d.corners, d.scores, d.labels, d.gt_corners,
                              d.gt_labels, stat)
    ms = report_time(len(rates), t0, dev)

    res = eval_multiclass_results(stat)
    res["comm_rate"] = float(np.mean(rates)) if rates else 0.0
    res["num_samples"] = len(rates)
    lines = [f"samples: {len(rates)}  comm_rate: {res['comm_rate']:.4f}"]
    for c in sorted(res["per_class"]):
        aps = res["per_class"][c]
        lines.append(f"class {c}: " + "  ".join(
            f"AP@{t}: {aps.get(f'ap_{int(t * 100)}', 0.0):.4f}"
            for t in IOU_THRESHOLDS))
    lines.append("  ".join(f"mAP@{t}: {res[f'map_{int(t * 100)}']:.4f}"
                           for t in IOU_THRESHOLDS))
    for line in lines:
        print(line)
    with open(os.path.join(opt.model_dir, "results_multiclass.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    yaml_res = {
        "per_class": {int(c): {k: float(v) for k, v in d.items()}
                      for c, d in res["per_class"].items()},
        **{k: float(v) for k, v in res.items() if k != "per_class"},
    }
    save_yaml(yaml_res, os.path.join(opt.model_dir,
                                      f"eval_multiclass_epoch{epoch}.yaml"))
    return dict(res, ms_per_scene=ms)


if __name__ == "__main__":
    main()
