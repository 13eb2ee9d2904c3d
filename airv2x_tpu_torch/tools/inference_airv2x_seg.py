"""BEV segmentation mIoU evaluation CLI (counterpart of
airv2x_tpu/tools/inference_airv2x_seg.py).

    python -m airv2x_tpu_torch.tools.inference_airv2x_seg --model_dir <run dir>
        [--test_dir dataset/airv2x/test] [--epoch N] [--num_scenes N]
        [--max_samples N] [--seed N] [--device cuda|cpu]

The argmax label maps of each branch's logits, bucketed per scenario, then
per-class IoU / Dice / precision / recall / F1 and mIoU per branch and
combined. The dataset's label maps when the test dir exists (a sample
without them gets its boxes rasterized, and an all-background static map);
synthetic scenes with rasterized labels otherwise. Appends to
``results_seg.txt`` and writes ``eval_seg_epoch{N}.yaml``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from airv2x_tpu_torch.config import save_yaml
from airv2x_tpu_torch.data.synthetic import rasterize_seg_labels
from airv2x_tpu_torch.eval.seg_metrics import evaluate_branch
from airv2x_tpu_torch.tools.inference import (
    load_run, model_batch, report_time, scenes)
from airv2x_tpu_torch.utils.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="seg mIoU evaluation")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--test_dir", default="")
    p.add_argument("--epoch", type=int, default=0, help="0 = best epoch")
    p.add_argument("--num_scenes", type=int, default=16, help="synthetic fallback")
    p.add_argument("--max_samples", type=int, default=0, help="0 = all")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def seg_step(model, device):
    """``step(scene) -> ({branch: (H, W) int64 labels}, rate)``: the argmax
    of each branch's logits, as the JAX CLI takes it."""
    def step(scene):
        with torch.inference_mode():
            out = model(model_batch(scene, device))
            pred = {branch: out[f"{branch}_seg"][0].argmax(-1).cpu().numpy()
                    for branch in ("dynamic", "static") if f"{branch}_seg" in out}
        return pred, float(out.get("comm_rate", 1.0))

    return step


def main(argv=None) -> dict:
    """Run the evaluation; returns the result dict (and "ms_per_scene")."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, epoch = load_run(opt.model_dir, dev, opt.epoch)
    margs = hypes["model"]["args"]
    if hypes.get("task", margs.get("task")) != "seg":
        raise SystemExit("model_dir config is not a seg-task experiment")
    seg_hw = int(hypes.get("seg_hw", margs["seg_hw"]))
    seg_res = float(hypes.get("seg_res", margs.get("seg_res", 0.25)))
    step = seg_step(model, dev)
    source, it = scenes(hypes, model.layout,
                        opt.test_dir or hypes.get("test_dir", ""),
                        opt.num_scenes, opt.seed, max_samples=opt.max_samples)
    print(source)

    buckets, rates = {}, []
    t0 = time.perf_counter()
    for scen, scene, gt in it:
        dyn = scene.get("dynamic_seg_label")
        if dyn is None:
            dyn = rasterize_seg_labels(gt["boxes"], gt["mask"], gt["classes"],
                                       seg_hw, seg_res)
        sta = scene.get("static_seg_label")
        if sta is None:
            sta = np.zeros_like(dyn)
        pred, rate = step(scene)
        rates.append(rate)
        b = buckets.setdefault(scen, {"gd": [], "pd": [], "gs": [], "ps": []})
        if "dynamic" in pred:
            b["gd"].append(dyn)
            b["pd"].append(pred["dynamic"])
        if "static" in pred:
            b["gs"].append(sta)
            b["ps"].append(pred["static"])
    ms = report_time(len(rates), t0, dev)

    classes = {"dynamic": int(margs.get("dynamic_class", 7)),
               "static": int(margs.get("static_class", 3))}

    def branch_eval(gts, preds, branch):
        if not gts:
            return None
        return evaluate_branch(np.stack(gts), np.stack(preds),
                               num_classes=classes[branch])

    lines = [f"samples: {len(rates)}  comm_rate: {float(np.mean(rates)):.4f}"]
    all_b = {"gd": [], "pd": [], "gs": [], "ps": []}
    for scen, b in sorted(buckets.items()):
        parts = []
        d = branch_eval(b["gd"], b["pd"], "dynamic")
        s = branch_eval(b["gs"], b["ps"], "static")
        if d:
            parts.append(f"dyn mIoU {d['mean_iou']:.4f}")
        if s:
            parts.append(f"sta mIoU {s['mean_iou']:.4f}")
        for k in all_b:
            all_b[k] += b[k]
        lines.append(f"{scen}: " + "  ".join(parts))

    result = {"num_samples": len(rates),
              "comm_rate": float(np.mean(rates)) if rates else 0.0}
    combined = []
    for branch, g, p in (("dynamic", "gd", "pd"), ("static", "gs", "ps")):
        r = branch_eval(all_b[g], all_b[p], branch)
        if not r:
            continue
        lines.append("{}: mIoU {:.4f}  per-class IoU {}".format(
            branch.upper(), r["mean_iou"],
            " ".join(f"{v:.3f}" for v in r["iou_per_class"])))
        result[branch] = {k: (v.tolist() if isinstance(v, np.ndarray) else float(v))
                          for k, v in r.items()}
        combined.append(r["mean_iou"])
    if combined:
        result["combined_miou"] = float(np.mean(combined))
        lines.append(f"COMBINED mIoU: {result['combined_miou']:.4f}")
    for line in lines:
        print(line)
    with open(os.path.join(opt.model_dir, "results_seg.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    save_yaml(result, os.path.join(opt.model_dir, f"eval_seg_epoch{epoch}.yaml"))
    return dict(result, ms_per_scene=ms)


if __name__ == "__main__":
    main()
