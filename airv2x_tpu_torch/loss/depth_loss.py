"""LSS depth-supervision loss (counterpart of airv2x_tpu/loss/depth_loss.py):
the multiclass detection loss plus, when the output carries the camera
branch's ``depth_logits`` (..., D) and the target its ``depth_labels``
(...), bin indices, a depth-bin classification term: the mean negative
log-likelihood in f32, weighted by ``depth_weight`` (default 1)."""

from __future__ import annotations

import torch

from airv2x_tpu_torch.loss.point_pillar_multiclass import make_multiclass_loss
from airv2x_tpu_torch.loss.registry import register_loss


@register_loss("point_pillar_depth_loss")
def make_depth_loss(args: dict):
    base = make_multiclass_loss(args)
    depth_weight = float(args.get("depth_weight", 1.0))

    def loss_fn(output: dict, target: dict):
        total, parts = base(output, target)
        logits = output.get("depth_logits")
        if logits is None or "depth_labels" not in target:
            return total, parts
        logp = torch.log_softmax(logits.float(), dim=-1)
        labels = target["depth_labels"].long()
        dloss = -logp.gather(-1, labels[..., None])[..., 0].mean()
        total = total + depth_weight * dloss
        return total, {**parts, "depth_loss": dloss, "total_loss": total}

    return loss_fn
