"""Inference straight from a checkpoint file and a config, no run dir
needed (counterpart of airv2x_tpu/tools/inference_pretrained.py).

    python -m airv2x_tpu_torch.tools.inference_pretrained
        --model_path net_epoch50.pth --hypes_yaml config.yaml
        [--num_scenes N] [--comm_thre x] [--save_npy] [--save_vis_n N]
        [--out_dir DIR] [--seed N] [--device cuda|cpu]

``--model_path`` takes either a reference torch ``.pth`` / ``.pt`` state
dict (converted in memory through ``utils/torch_convert.py``, the map
``tools/convert_checkpoint.py`` writes out) or a ``net_epoch{N}`` checkpoint
of a port run dir. ``--comm_thre`` sets every ``communication.thre`` of the
model args (the reference's override), ``--save_npy`` writes each frame's
points, predicted corners and scores and gt corners as ``npy/{i:04d}_*.npy``,
``--save_vis_n`` renders the first N frames' BEV views, and the AP line is
appended to ``results.txt`` in ``--out_dir`` (default: beside the checkpoint).
The scenes are ``make_scene``'s, seeded by ``--seed``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.eval.ap import accumulate_scene, eval_final_results, new_result_stat
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.tools.convert_checkpoint import report
from airv2x_tpu_torch.tools.inference import det_step, report_time, scenes
from airv2x_tpu_torch.utils.checkpoint import load_model_weights
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.torch_convert import (
    load_reference_checkpoint, read_checkpoint)
from airv2x_tpu_torch.utils.weights import cast_weights_, init_flax_like_
from airv2x_tpu_torch.visualization.bev_canvas import visualize


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="inference from a bare checkpoint")
    p.add_argument("--model_path", required=True,
                   help=".pth state dict or a net_epoch{N} checkpoint")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--num_scenes", type=int, default=16)
    p.add_argument("--comm_thre", type=float, default=None,
                   help="override the fusion communication threshold")
    p.add_argument("--save_npy", action="store_true",
                   help="dump pred/gt corners + scores per frame as npy")
    p.add_argument("--save_vis_n", type=int, default=0,
                   help="save BEV renders for the first N frames")
    p.add_argument("--out_dir", default="",
                   help="output dir (default: alongside the checkpoint)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _apply_comm_thre(hypes: dict, thre: float) -> None:
    """Set every ``communication.thre`` in the model args to ``thre``."""
    def walk(node):
        if isinstance(node, dict):
            comm = node.get("communication")
            if isinstance(comm, dict) and "thre" in comm:
                comm["thre"] = thre
            for v in node.values():
                walk(v)
    walk(hypes["model"]["args"])


def load_model(hypes: dict, model_path: str, device):
    """The eval model of ``hypes`` on ``device`` with the weights of
    ``model_path``: a reference ``.pth`` converted in memory, or a port
    ``net_epoch{N}``; cast to bf16 when the config computes in bf16."""
    model = init_flax_like_(build_model(hypes, device=device), 0)
    if model_path.endswith((".pth", ".pt")):
        report(load_reference_checkpoint(model, read_checkpoint(model_path), hypes),
               False)
    else:
        run_dir, name = os.path.split(os.path.normpath(model_path))
        if not name.startswith("net_epoch"):
            raise SystemExit(f"--model_path must be a .pth or a net_epoch{{N}} "
                             f"checkpoint, got {model_path}")
        load_model_weights(run_dir, int(name.replace("net_epoch", "")), model)
    if compute_dtype(hypes) == torch.bfloat16:
        cast_weights_(model, torch.bfloat16)
    return model.eval()


def main(argv=None) -> dict:
    """Run the evaluation; returns the AP dict (and ms per scene)."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml)
    if opt.comm_thre is not None:
        _apply_comm_thre(hypes, opt.comm_thre)
    model = load_model(hypes, opt.model_path, dev)
    lidar_range = hypes["preprocess"]["cav_lidar_range"]

    out_dir = opt.out_dir or (os.path.dirname(os.path.abspath(opt.model_path)) or ".")
    os.makedirs(out_dir, exist_ok=True)
    npy_dir = os.path.join(out_dir, "npy")
    if opt.save_npy:
        os.makedirs(npy_dir, exist_ok=True)

    step = det_step(hypes, model, dev)
    _, it = scenes(hypes, model.layout, "", opt.num_scenes, opt.seed)
    stat, rates = new_result_stat(), []
    t0 = time.perf_counter()
    for i, (_, scene, gt) in enumerate(it):
        d = step(scene, gt)
        rates.append(d.rate)
        accumulate_scene(d.corners, d.scores, d.gt_corners, stat)
        if opt.save_npy or i < opt.save_vis_n:
            pts = scene["points"][scene["points_mask"]].reshape(-1, 4)
            det_c, gt_c = d.corners3d.cpu().numpy(), d.gt_corners3d.cpu().numpy()
        if opt.save_npy:
            np.save(os.path.join(npy_dir, f"{i:04d}_pcd.npy"), pts)
            np.save(os.path.join(npy_dir, f"{i:04d}_pred.npy"), det_c)
            np.save(os.path.join(npy_dir, f"{i:04d}_pred_score.npy"), d.scores)
            np.save(os.path.join(npy_dir, f"{i:04d}_gt.npy"), gt_c)
        if i < opt.save_vis_n:
            visualize(det_c, gt_c, pts, lidar_range,
                      save_path=os.path.join(out_dir, f"vis_{i:04d}.png"))
    ms = report_time(len(rates), t0, dev)

    res = eval_final_results(stat)
    res["comm_rate"] = float(np.mean(rates))
    msg = (f"AP@0.3: {res['ap_30']:.4f} AP@0.5: {res['ap_50']:.4f} "
           f"AP@0.7: {res['ap_70']:.4f} comm_rate: {res['comm_rate']:.4f}")
    print(msg)
    with open(os.path.join(out_dir, "results.txt"), "a") as f:
        f.write(msg + "\n")
    return dict(res, ms_per_scene=ms)


if __name__ == "__main__":
    main()
