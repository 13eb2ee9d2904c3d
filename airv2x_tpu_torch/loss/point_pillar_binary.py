"""Binary-class PointPillar losses of the OPV2V / DAIR family (counterpart of
airv2x_tpu/loss/point_pillar_binary.py): ``make_binary_loss``, registered as
``point_pillar_loss`` and ``point_pillar_loss_opencood``, and the two that
add a term to it, CoAlign's (``point_pillar_loss_coalign``), DiscoNet's
(``point_pillar_disconet_loss``) and MDD's (``point_pillar_loss_mdd``).

  * focal loss (alpha 0.25, gamma 2) on one sigmoid score per anchor,
    weighted by (pos + neg) / num_pos per sample, summed over the batch and
    divided by the batch size once;
  * weighted smooth-L1 (beta 1/9) regression with sin-difference yaw,
    weighted by pos / num_pos.

Predictions are NHWC (cast to f32 here); ``prefix`` selects ``psm<prefix>``
/ ``rm<prefix>`` and suffixes the parts' names.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.loss.point_pillar_multiclass import (
    add_sin_difference, sigmoid_ce, smooth_l1)
from airv2x_tpu_torch.loss.registry import register_loss
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.boxes import decode_boxes
from airv2x_tpu_torch.ops.rotated_iou import elementwise_quad_iou


@register_loss("point_pillar_loss", "point_pillar_loss_opencood")
def make_binary_loss(args: dict):
    cls_weight = float(args.get("cls_weight", 1.0))
    reg_coe = float(args.get("reg", 2.0))
    alpha, gamma = 0.25, 2.0

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        psm = output[f"psm{prefix}"].float()  # (B, H, W, A)
        rm = output[f"rm{prefix}"].float()  # (B, H, W, 7A)
        b = psm.shape[0]

        flat_pos = target["pos_equal_one"].reshape(b, -1)
        positives = flat_pos > 0
        negatives = flat_pos == 0
        pos_norm = positives.sum(1, keepdim=True).float().clamp_min(1.0)
        cls_w = (negatives.float() + positives.float()) / pos_norm
        reg_w = positives.float() / pos_norm

        logits = psm.reshape(b, -1)
        tgt_cls = flat_pos.float()
        pred_sig = torch.sigmoid(logits)
        alpha_w = tgt_cls * alpha + (1 - tgt_cls) * (1 - alpha)
        pt = tgt_cls * (1 - pred_sig) + (1 - tgt_cls) * pred_sig
        focal = alpha_w * pt**gamma * sigmoid_ce(logits, tgt_cls) * cls_w
        conf_loss = focal.sum() / b * cls_weight

        tgt = target["targets"].reshape(b, -1, 7)
        pred = rm.reshape(b, -1, 7)
        sp, st = add_sin_difference(pred[..., 6], tgt[..., 6])
        pred = torch.cat([pred[..., :6], sp[..., None]], dim=-1)
        tgt = torch.cat([tgt[..., :6], st[..., None]], dim=-1)
        reg_loss = (smooth_l1(pred - tgt) * reg_w[..., None]).sum() / b * reg_coe

        total = conf_loss + reg_loss
        return total, {f"total_loss{prefix}": total,
                       f"conf_loss{prefix}": conf_loss,
                       f"reg_loss{prefix}": reg_loss}

    return loss_fn


def _with_term(parts: dict, total, prefix: str, name: str, value) -> dict:
    parts = dict(parts)
    parts[name] = value
    parts[f"total_loss{prefix}"] = total
    return parts


@register_loss("point_pillar_loss_coalign")
def make_coalign_loss(args: dict):
    """The binary loss plus ``iou_weight`` x the mean of (1 - IoU) over the
    positive anchors, the IoU that of the BEV quads of the decoded predicted
    and target boxes (``ops/rotated_iou.py``, differentiable). The term
    applies only where the labels carry the anchor grid (``anchors``,
    (H, W, A, 7)); neither package's loaders put it there (ROADMAP §3)."""
    base = make_binary_loss(args)
    iou_weight = float(args.get("iou_weight", 1.0))

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        total, parts = base(output, target, prefix)
        if "anchors" not in target:
            return total, parts
        rm = output[f"rm{prefix}"].float()
        b = rm.shape[0]
        anchors = target["anchors"].reshape(-1, 7)[None]
        pred = decode_boxes(rm.reshape(b, -1, 7), anchors)
        gt = decode_boxes(target["targets"].reshape(b, -1, 7).float(), anchors)
        iou = elementwise_quad_iou(geo.boxes_to_corners_bev(pred, order="hwl"),
                                   geo.boxes_to_corners_bev(gt, order="hwl"))
        pos = target["pos_equal_one"].reshape(b, -1).float()
        iou_loss = ((1.0 - iou) * pos).sum() / pos.sum().clamp_min(1.0)
        total = total + iou_weight * iou_loss
        return total, _with_term(parts, total, prefix, "iou_loss", iou_loss)

    return loss_fn


@register_loss("point_pillar_disconet_loss")
def make_disconet_loss(args: dict):
    """The binary loss plus the weighted KL divergence of the student's
    per-pixel channel distribution from the teacher's (softmax over the
    channels of ``student_feature`` / ``teacher_feature``, NHWC), averaged
    over the pixels. The weight is ``kd.weight`` (default 1e5) where ``kd``
    is a block, else ``kd_weight`` (default 1). Without both features the
    loss is the binary one."""
    base = make_binary_loss(args)
    kd = args.get("kd")
    kd_weight = (float(kd.get("weight", 1e5)) if isinstance(kd, dict)
                 else float(args.get("kd_weight", 1.0)))

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        total, parts = base(output, target, prefix)
        if "student_feature" not in output or "teacher_feature" not in output:
            return total, parts
        s = torch.log_softmax(output["student_feature"].float(), dim=-1)
        t = torch.softmax(output["teacher_feature"].float(), dim=-1)
        kd_loss = (t * (torch.log(t + 1e-9) - s)).sum(-1).mean()
        total = total + kd_weight * kd_loss
        return total, _with_term(parts, total, prefix, "kd_loss", kd_loss)

    return loss_fn


@register_loss("point_pillar_loss_mdd")
def make_mdd_loss(args: dict):
    """The binary loss plus MDD's denoising term: the squared error of
    ``pred_feature`` against ``gt_feature`` (NHWC) summed over the
    channels and averaged over the pixels, times the epoch schedule
    1.5 (1 - tanh(epoch / 4 - 5)), the epoch (1-based) from the labels'
    ``epoch`` (default 1). Without both features (eval) the loss is the
    binary one."""
    base = make_binary_loss(args)

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        total, parts = base(output, target, prefix)
        if "pred_feature" not in output or "gt_feature" not in output:
            return total, parts
        epoch = torch.as_tensor(target.get("epoch", 1), dtype=torch.float32,
                                device=total.device)
        weight = 1.5 * (1.0 - torch.tanh(epoch / 4.0 - 5.0))
        diff = output["gt_feature"].float() - output["pred_feature"].float()
        diff_loss = (diff ** 2).sum(-1).mean() * weight
        total = total + diff_loss
        return total, _with_term(parts, total, prefix, "diff_loss", diff_loss)

    return loss_fn
