"""Inference + AP evaluation CLI on synthetic scenes (counterpart of
airv2x_tpu/tools/inference.py), and the pieces the other evaluation CLIs
share: ``load_run``, ``scenes``, ``det_step`` and ``report_time``.

    python -m airv2x_tpu_torch.tools.inference --model_dir <run dir>
        [--epoch N] [--num_scenes N] [--obj_threshold x] [--seed N]
        [--device cuda|cpu]

Loads the best (or the given) epoch of a run dir written by the port's
train CLI (``torch.save`` checkpoints: the JAX package's orbax run dirs are
not read), decodes each scene's detections (objectness gate -> filters ->
rotated NMS), and reports VOC AP at IoU 0.3 / 0.5 / 0.7 and the mean
communication rate, appending to ``results.txt`` and writing
``eval_epoch{N}.yaml`` in the run dir as the JAX CLI does.

``--fusion_method late`` runs the model once per agent instead (``late_batch``:
the scene replicated L times, replica i with only agent i live and identity
pairwise transforms, batch L), then fuses the agents' boxes in the ego frame
(``decode_late_fusion``: one joint rotated NMS). Like the JAX CLI it needs a
multiclass config: a binary-head config has no ``num_class`` (KeyError) and
its heads no class logits (``decode_late_fusion`` raises).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
from airv2x_tpu_torch.data.postprocess import decode_detections, decode_late_fusion
from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
from airv2x_tpu_torch.eval.ap import (
    accumulate_scene, eval_final_results, new_result_stat)
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.tools.train import needs_radar
from airv2x_tpu_torch.utils.checkpoint import find_best_epoch, load_model_weights
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import cast_weights_

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="airv2x_tpu_torch inference")
    p.add_argument("--model_dir", type=str, required=True)
    p.add_argument("--hypes_yaml", type=str, default="")
    p.add_argument("--epoch", type=int, default=0, help="0 = best epoch")
    p.add_argument("--num_scenes", type=int, default=32)
    p.add_argument("--obj_threshold", type=float, default=0.0,
                   help="override the config's objectness gate (0 = config)")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--fusion_method", choices=["intermediate", "late"],
                   default="intermediate")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_run(model_dir: str, device="cuda", epoch: int = 0,
             hypes_yaml: str = ""):
    """(hypes, eval model, epoch) of a run dir: its ``config.yaml``
    snapshot (else ``hypes_yaml``), the model built on ``device`` with the
    given or the best epoch's weights (random ones, with a warning, when
    the run dir holds no checkpoint), in eval mode and cast to bf16 when
    the config computes in bf16 (the BatchNorms stay f32)."""
    dev = resolve_device(device)
    hypes = load_yaml(hypes_yaml or None, model_dir)
    model = build_model(hypes, device=dev)
    epoch = epoch or find_best_epoch(model_dir)
    if epoch:
        load_model_weights(model_dir, epoch, model)
        print(f"loaded epoch {epoch}")
    else:
        print("WARNING: no checkpoint found, evaluating random init")
    if compute_dtype(hypes) == torch.bfloat16:
        cast_weights_(model, torch.bfloat16)
    return hypes, model, epoch


def scenes(hypes, layout, test_dir: str, num_scenes: int, seed: int,
           max_samples: int = 0, num_objects: int = 12):
    """(source line, iterator of (scenario, batch, gt)): the samples of
    the AirV2X split at ``test_dir`` (at most ``max_samples``, 0 = all)
    when it exists, else ``num_scenes`` synthetic ``make_scene`` scenes in
    four scenario buckets (LiDAR, plus a radar cloud for the models that
    read one, as the JAX CLIs' fallback: a camera config needs the
    dataset)."""
    max_points = int(hypes["preprocess"].get("max_points", 8192))
    radar = needs_radar(hypes)
    if test_dir and os.path.isdir(test_dir):
        ds = AirV2XDataset(hypes, test_dir, train=False)
        n = min(len(ds), max_samples) if max_samples else len(ds)

        def dataset_iter():
            for i in range(n):
                yield (os.path.basename(ds.samples[i][0]), *ds[i])

        return f"dataset: {n} samples of {test_dir}", dataset_iter()

    def synthetic_iter():
        rng = np.random.default_rng(seed)
        for i in range(num_scenes):
            batch, gt = make_scene(
                rng, layout, num_objects=num_objects, points_per_agent=max_points,
                lidar_range=hypes["preprocess"]["cav_lidar_range"],
                radar_points_per_agent=max_points // 8 if radar else 0)
            yield f"synthetic_{i % 4}", batch, gt

    absent = f" (no dataset at {test_dir})" if test_dir else ""
    return f"synthetic: {num_scenes} make_scene scenes{absent}", synthetic_iter()


def model_batch(scene: dict, device) -> dict:
    """One numpy sample -> a batch of one on ``device`` (labels left out;
    the ``cam_<type>`` blocks leaf by leaf)."""
    def lead(v):
        return {k: x[None] for k, x in v.items()} if isinstance(v, dict) else v[None]

    return batch_to_torch({k: lead(v) for k, v in scene.items()
                           if not k.endswith("_seg_label")}, device)


class SceneDets(NamedTuple):
    corners: torch.Tensor  # (K, 4, 2) kept BEV quads, on the model's device
    scores: np.ndarray  # (K,)
    labels: np.ndarray  # (K,) class ids
    gt_corners: torch.Tensor  # (G, 4, 2) valid gt quads, same device
    gt_labels: np.ndarray  # (G,)
    rate: float  # communication rate
    boxes: np.ndarray  # (K, 7) kept hwl boxes
    corners3d: torch.Tensor  # (K, 8, 3) kept box corners, model's device
    gt_corners3d: torch.Tensor  # (G, 8, 3) valid gt box corners, same device


def late_batch(batch: dict) -> dict:
    """A batch of one scene -> its late-fusion batch of L replicas: replica i
    holds the scene's points with only agent i live (where present) and
    identity ``pairwise_t`` (L, L, 4, 4) / ``pairwise_t_full``
    (L, L, L, 4, 4)."""
    l = batch["points"].shape[1]
    dev = batch["points"].device

    def rep(a):
        return a[0][None].expand((l,) + a[0].shape)

    eye = torch.eye(4, device=dev)
    out = {k: rep(batch[k]) for k in ("points", "points_mask", "prior_encoding")
           if k in batch}
    out["agent_mask"] = (torch.eye(l, dtype=torch.bool, device=dev)
                         & batch["agent_mask"][0].bool()[None])
    out["pairwise_t"] = eye.expand(l, l, 4, 4)
    out["pairwise_t_full"] = eye.expand(l, l, l, 4, 4)
    return out


def det_step(hypes, model, device, obj_threshold: float = 0.0,
             late: bool = False):
    """``step(scene, gt) -> SceneDets``: one numpy scene through the model,
    ``decode_detections`` (rotated NMS) and the gt's BEV corners, all on
    ``device``. With ``late``, late fusion: the scene's ``late_batch``
    through the model, then ``decode_late_fusion`` with the scene's own
    ``pairwise_t`` (one joint NMS)."""
    dev = resolve_device(device)
    anchors = torch.from_numpy(
        generate_anchor_grid(hypes["postprocess"]["anchor_args"])).to(dev)
    lidar_range = torch.tensor(hypes["preprocess"]["cav_lidar_range"],
                               dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    post = hypes["postprocess"]
    kw = dict(num_class=int(hypes["num_class"]),
              obj_threshold=obj_threshold or post["target_args"]["obj_threshold"],
              nms_thresh=post["nms_thresh"], top_k=int(post.get("nms_top_k", 512)))

    def step(scene, gt):
        with torch.inference_mode():
            batch = model_batch(scene, dev)
            if late:
                out = model(late_batch(batch))
                det = decode_late_fusion(
                    out["psm"], out["rm"], out.get("obj", out["psm"]), anchors,
                    batch["pairwise_t"][0], batch["agent_mask"][0], lidar_range,
                    **kw)
            else:
                out = model(batch)
                det = decode_detections(out["psm"][0], out["rm"][0],
                                        out.get("obj", out["psm"])[0], anchors,
                                        eye, lidar_range, **kw)
            keep = det.mask
            gm = gt["mask"].astype(bool)
            gt_c3 = geo.boxes_to_corners_3d(
                torch.from_numpy(gt["boxes"][gm]).to(dev), order="hwl")
        corners3d = det.corners[keep]
        return SceneDets(
            corners=corners3d[:, :4, :2], scores=det.scores[keep].cpu().numpy(),
            labels=det.labels[keep].cpu().numpy(), gt_corners=gt_c3[:, :4, :2],
            gt_labels=np.asarray(gt["classes"])[gm],
            rate=float(out.get("comm_rate", 0.0 if late else 1.0)),
            boxes=det.boxes[keep].cpu().numpy(), corners3d=corners3d,
            gt_corners3d=gt_c3)

    return step


def report_time(n: int, t0: float, device) -> float:
    """Print and return the host ms per scene since ``t0`` (load, forward,
    decode and metric accumulation; the device synchronised first)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(n, 1) * 1e3
    print(f"{n} scenes in {ms * n / 1e3:.3f} s: {ms:.3f} ms/scene (load + "
          "forward + decode + metrics, host clock)")
    return ms


def main(argv=None) -> dict:
    """Run the evaluation; returns the result dict it writes."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes, model, epoch = load_run(opt.model_dir, dev, opt.epoch, opt.hypes_yaml)
    step = det_step(hypes, model, dev, opt.obj_threshold,
                    late=opt.fusion_method == "late")
    source, it = scenes(hypes, model.layout, "", opt.num_scenes, opt.seed,
                        num_objects=8)
    print(source)

    stat = new_result_stat()
    rates = []
    t0 = time.perf_counter()
    for _, scene, gt in it:
        d = step(scene, gt)
        rates.append(d.rate)
        accumulate_scene(d.corners, d.scores, d.gt_corners, stat)
    ms = report_time(len(rates), t0, dev)

    res = eval_final_results(stat)
    res["comm_rate"] = float(np.mean(rates))
    msg = (f"AP@0.3: {res['ap_30']:.4f} AP@0.5: {res['ap_50']:.4f} "
           f"AP@0.7: {res['ap_70']:.4f} comm_rate: {res['comm_rate']:.4f}")
    print(msg)
    with open(os.path.join(opt.model_dir, "results.txt"), "a") as f:
        f.write(msg + "\n")
    save_yaml(res, os.path.join(opt.model_dir, f"eval_epoch{epoch}.yaml"))
    return dict(res, ms_per_scene=ms)


if __name__ == "__main__":
    main()
