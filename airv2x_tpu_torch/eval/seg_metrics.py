"""BEV segmentation metrics (copy of airv2x_tpu/eval/seg_metrics.py, numpy).

Sigmoid-thresholded first-class-wins labels, per-class IoU / Dice (an empty
class counts 1.0), precision / recall / F1, pixel accuracy, and the
dynamic / static combined means.
"""

from __future__ import annotations

import numpy as np


def _probs_to_labels(pred: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """(..., H, W, C) sigmoid probabilities -> (..., H, W) int labels: the
    first class over the threshold, offset by 1 (0 = none over it)."""
    over = pred > threshold
    first = np.argmax(over, axis=-1) + 1
    return np.where(over.any(axis=-1), first, 0).astype(np.int32)


def evaluate_branch(gt: np.ndarray, pred: np.ndarray,
                    num_classes: int | None = None):
    gt_flat = gt.reshape(-1)
    pred_flat = pred.reshape(-1)
    if num_classes is None:
        num_classes = int(max(gt_flat.max(), pred_flat.max())) + 1

    iou, dice, precision, recall, f1 = [], [], [], [], []
    for c in range(num_classes):
        g = gt_flat == c
        p = pred_flat == c
        inter = np.logical_and(g, p).sum()
        union = np.logical_or(g, p).sum()
        iou.append(1.0 if union == 0 else inter / union)
        denom = g.sum() + p.sum()
        dice.append(1.0 if denom == 0 else 2 * inter / denom)
        prec = inter / p.sum() if p.sum() > 0 else 0.0
        rec = inter / g.sum() if g.sum() > 0 else 0.0
        precision.append(prec)
        recall.append(rec)
        f1.append(0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec))

    return {
        "iou_per_class": np.array(iou),
        "mean_iou": float(np.mean(iou)),
        "dice_per_class": np.array(dice),
        "mean_dice": float(np.mean(dice)),
        "precision_per_class": np.array(precision),
        "mean_precision": float(np.mean(precision)),
        "recall_per_class": np.array(recall),
        "mean_recall": float(np.mean(recall)),
        "f1_per_class": np.array(f1),
        "mean_f1": float(np.mean(f1)),
        "pixel_accuracy": float((gt_flat == pred_flat).mean()),
    }


def evaluate_segmentation(gt_dynamic: np.ndarray, pred_dynamic: np.ndarray,
                          gt_static: np.ndarray, pred_static: np.ndarray,
                          threshold: float = 0.5):
    """gt_*: (..., H, W) int labels; pred_*: (..., H, W, C) sigmoid
    probabilities or (..., H, W) labels."""
    if pred_dynamic.ndim > gt_dynamic.ndim:
        pred_dynamic = _probs_to_labels(pred_dynamic, threshold)
    if pred_static.ndim > gt_static.ndim:
        pred_static = _probs_to_labels(pred_static, threshold)
    dyn = evaluate_branch(gt_dynamic, pred_dynamic)
    sta = evaluate_branch(gt_static, pred_static)
    combined = {
        "mean_iou": (dyn["mean_iou"] + sta["mean_iou"]) / 2,
        "mean_dice": (dyn["mean_dice"] + sta["mean_dice"]) / 2,
        "pixel_accuracy": (dyn["pixel_accuracy"] + sta["pixel_accuracy"]) / 2,
    }
    return {"dynamic": dyn, "static": sta, "combined": combined}
