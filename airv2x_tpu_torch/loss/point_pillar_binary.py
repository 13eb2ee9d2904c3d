"""Binary-class PointPillar loss of the OPV2V / DAIR family (counterpart of
airv2x_tpu/loss/point_pillar_binary.py: ``make_binary_loss``, registered as
``point_pillar_loss`` and ``point_pillar_loss_opencood``).

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
