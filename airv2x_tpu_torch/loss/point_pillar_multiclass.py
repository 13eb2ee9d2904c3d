"""Multiclass PointPillar detection loss (counterpart of
airv2x_tpu/loss/point_pillar_multiclass.py).

  * per-anchor multiclass focal loss (alpha 0.25, gamma 2) on sigmoid logits
    against one-hot class targets, weighted by (pos + all-neg) / num_pos;
  * weighted smooth-L1 (beta 1/9) regression with sin-difference yaw,
    weighted by pos / num_pos;
  * objectness BCE against the positive mask as log(sigmoid + 1e-6), mean
    over the map.

The reference's normalisation quirks are kept: the focal term is divided by
the batch size twice. Predictions are NHWC f32 (cast here), targets as
``ops/anchors.py:assign_targets`` makes them; ``prefix`` selects
``psm<prefix>`` / ``rm<prefix>`` / ``obj<prefix>`` and suffixes the parts'
names (SiCP's dual heads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from airv2x_tpu_torch.loss.registry import register_loss


def sigmoid_ce(logits, targets):
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def smooth_l1(diff, beta=1.0 / 9.0):
    n = diff.abs()
    return torch.where(n < beta, 0.5 * n**2 / beta, n - 0.5 * beta)


def add_sin_difference(pred_yaw, tgt_yaw):
    return (torch.sin(pred_yaw) * torch.cos(tgt_yaw),
            torch.cos(pred_yaw) * torch.sin(tgt_yaw))


@register_loss("point_pillar_loss_multiclass")
def make_multiclass_loss(args: dict):
    cls_weight = float(args["cls_weight"])
    reg_coe = float(args["reg"])
    num_class = int(args["num_class"])
    obj_weight = float(args.get("obj_weight", 1.0))
    alpha, gamma = 0.25, 2.0

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        psm = output[f"psm{prefix}"].float()  # (B, H, W, A*C)
        rm = output[f"rm{prefix}"].float()  # (B, H, W, 7A)
        obj = output[f"obj{prefix}"].float()  # (B, H, W, A)
        pos = target["pos_equal_one"]  # (B, H, W, A)
        b, a = psm.shape[0], pos.shape[-1]

        flat_pos = pos.reshape(b, -1)
        positives = flat_pos > 0
        negatives = flat_pos == 0
        pos_norm = positives.sum(1, keepdim=True).float().clamp_min(1.0)
        cls_w = (negatives.float() + positives.float()) / pos_norm
        reg_w = positives.float() / pos_norm

        # multiclass focal cls
        one_hot = F.one_hot(target["class_ids"].long(), num_class).float()
        logits = psm.reshape(b, *pos.shape[1:3], a, num_class)
        pred_sig = torch.sigmoid(logits)
        alpha_w = one_hot * alpha + (1 - one_hot) * (1 - alpha)
        pt = one_hot * (1 - pred_sig) + (1 - one_hot) * pred_sig
        focal = alpha_w * pt**gamma * sigmoid_ce(logits, one_hot)
        focal = focal * cls_w.reshape(b, *pos.shape[1:3], a, 1)
        # the reference's double normalisation: sum / B inside, / B outside
        conf_loss = focal.sum() / b / b * cls_weight

        # regression
        tgt = target["targets"].reshape(b, -1, 7)
        pred = rm.reshape(b, -1, 7)
        sp, st = add_sin_difference(pred[..., 6], tgt[..., 6])
        pred = torch.cat([pred[..., :6], sp[..., None]], dim=-1)
        tgt = torch.cat([tgt[..., :6], st[..., None]], dim=-1)
        loc = smooth_l1(pred - tgt) * reg_w[..., None]
        reg_loss = loc.sum() / b * reg_coe

        # objectness BCE
        obj_sig = torch.sigmoid(obj)
        bce = -(pos * torch.log(obj_sig + 1e-6)
                + (1 - pos) * torch.log(1 - obj_sig + 1e-6))
        obj_loss = bce.mean() * obj_weight

        total = reg_loss + conf_loss + obj_loss
        return total, {f"total_loss{prefix}": total,
                       f"reg_loss{prefix}": reg_loss,
                       f"conf_loss{prefix}": conf_loss,
                       f"obj_loss{prefix}": obj_loss}

    return loss_fn
