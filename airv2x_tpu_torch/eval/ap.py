"""VOC-style detection AP (counterpart of airv2x_tpu/eval/ap.py).

Greedy score-descending matching of predicted against ground-truth BEV
quads at IoU 0.3 / 0.5 / 0.7 and VOC-2010 interpolated AP, per class for
the multiclass table. The det x gt IoU is ``ops/quad_iou.py:quad_iou`` in
its full (rectangular) mode, on the corners' device: K2 for CUDA tensors,
its plain version for CPU tensors or numpy arrays. The matching itself runs
on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from airv2x_tpu_torch.ops.quad_iou import quad_iou

IOU_THRESHOLDS = (0.3, 0.5, 0.7)


def new_result_stat():
    return {t: {"tp": [], "fp": [], "score": [], "gt": 0} for t in IOU_THRESHOLDS}


def _corners(c, device=None) -> torch.Tensor:
    return torch.as_tensor(c, dtype=torch.float32, device=device).contiguous()


def accumulate_scene(det_corners, det_scores, gt_corners, result_stat):
    """One scene into every threshold of ``result_stat``: det_corners
    (N, 4, 2) BEV quads, det_scores (N,) numpy, gt_corners (M, 4, 2); the
    corners numpy arrays or tensors. The det x gt IoU is computed once, on
    ``det_corners``' device (one K2 launch on the card), and matched
    greedily at each threshold."""
    for stat in result_stat.values():
        stat["gt"] += int(gt_corners.shape[0])
    if det_corners is None or det_corners.shape[0] == 0:
        return

    order = np.argsort(-det_scores)
    det = _corners(det_corners)
    det = det[torch.from_numpy(order).to(det.device)]
    scores = det_scores[order].tolist()
    gt = _corners(gt_corners, det.device)
    if gt.shape[0]:
        iou = quad_iou(det, gt).cpu().numpy()  # (N, M)
    else:
        iou = np.zeros((det.shape[0], 0), np.float32)
    for iou_thresh, stat in result_stat.items():
        gt_alive = np.ones(gt.shape[0], dtype=bool)
        tp = []
        for i in range(det.shape[0]):
            ious = np.where(gt_alive, iou[i], 0.0)
            hit = bool(gt_alive.any() and ious.max() >= iou_thresh)
            if hit:
                gt_alive[int(np.argmax(ious))] = False
            tp.append(int(hit))
        stat["tp"] += tp
        stat["fp"] += [1 - v for v in tp]
        stat["score"] += scores


def accumulate_tp_fp(det_corners, det_scores, gt_corners, result_stat,
                     iou_thresh):
    """``accumulate_scene`` at the one threshold ``iou_thresh`` (the JAX
    package's form)."""
    accumulate_scene(det_corners, det_scores, gt_corners,
                     {iou_thresh: result_stat[iou_thresh]})


def voc_ap(rec, prec):
    """VOC-2010 interpolated AP."""
    mrec = [0.0] + list(rec) + [1.0]
    mpre = [0.0] + list(prec) + [0.0]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap


def calculate_ap(result_stat, iou_thresh, global_sort_detections: bool = True):
    stat = result_stat[iou_thresh]
    fp, tp, score = (np.array(stat["fp"]), np.array(stat["tp"]),
                     np.array(stat["score"]))
    if stat["gt"] == 0 or len(tp) == 0:
        return 0.0
    if global_sort_detections:
        order = np.argsort(-score)
        fp, tp = fp[order], tp[order]
    fp_c = np.cumsum(fp)
    tp_c = np.cumsum(tp)
    rec = tp_c / stat["gt"]
    prec = tp_c / np.maximum(fp_c + tp_c, 1)
    return voc_ap(rec.tolist(), prec.tolist())


def eval_final_results(result_stat):
    return {f"ap_{int(t * 100)}": calculate_ap(result_stat, t)
            for t in IOU_THRESHOLDS}


def new_multiclass_stat(num_classes: int):
    return {c: new_result_stat() for c in range(1, num_classes + 1)}


def accumulate_multiclass(det_corners, det_scores, det_labels, gt_corners,
                          gt_labels, stat):
    """Per-class greedy matching: detections and gts bucketed by class and
    matched within it; every sample's gt counted once (the reference counts
    the first sample's twice, a quirk the JAX package does not keep). The
    labels and scores are numpy; the corners as ``accumulate_scene`` takes
    them (one IoU per class)."""
    det = None if det_corners is None else _corners(det_corners)
    gt = _corners(gt_corners, None if det is None else det.device)
    for c, class_stat in stat.items():
        gm = torch.from_numpy(np.asarray(gt_labels) == c).to(gt.device)
        d = s = None
        if det is not None:
            dm = np.asarray(det_labels) == c
            d, s = det[torch.from_numpy(dm).to(det.device)], det_scores[dm]
        accumulate_scene(d, s, gt[gm], class_stat)


def eval_multiclass_results(stat):
    """Per-class AP at each threshold and mAP over the classes that appear
    in the ground truth or the detections (det-only classes score 0)."""
    out = {"per_class": {}}
    for t in IOU_THRESHOLDS:
        aps = []
        for c, class_stat in stat.items():
            if class_stat[t]["gt"] == 0 and not class_stat[t]["score"]:
                continue
            ap = calculate_ap(class_stat, t)
            out["per_class"].setdefault(c, {})[f"ap_{int(t * 100)}"] = ap
            aps.append(ap)
        out[f"map_{int(t * 100)}"] = float(np.mean(aps)) if aps else 0.0
    return out
