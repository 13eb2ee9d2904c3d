"""BEV segmentation loss (counterpart of airv2x_tpu/loss/seg_loss.py
``vanilla_seg_loss``).

Class-weighted cross entropy on the dynamic (1 + d classes) and static
(weights [1, s, l]) branches, combined as ``d_coe * dynamic + s_coe *
static``; each branch is normalised by the sum of its pixels' target-class
weights, clamped at 1e-9 (torch's ``CrossEntropyLoss`` with class weights).
Predictions NHWC, labels (B, H, W) int.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.loss.registry import register_loss


def weighted_ce(logits, labels, class_weights):
    """sum(w_y * nll) / max(sum(w_y), 1e-9)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    w = class_weights[labels]
    return (w * nll).sum() / w.sum().clamp_min(1e-9)


@register_loss("vanilla_seg_loss")
def make_seg_loss(args: dict):
    seg_branch = args["seg_branch"]
    d_coe = float(args["d_coe"])
    s_coe = float(args["s_coe"])
    dyn_w = [1.0] + [float(v) for v in args["d_weights"]]
    sta_w = [1.0, float(args["s_weights"]), float(args.get("l_weights", 50.0))]

    def branch(output, target, key, weights):
        logits = output[f"{key}_seg"].float()
        w = torch.tensor(weights, dtype=torch.float32, device=logits.device)
        return weighted_ce(logits, target[f"{key}_seg_label"].long(), w)

    def loss_fn(output: dict, target: dict):
        zero = output["comm_rate"].new_zeros((), dtype=torch.float32)
        dynamic = static = zero
        if seg_branch in ("dynamic", "both"):
            dynamic = branch(output, target, "dynamic", dyn_w)
        if seg_branch in ("static", "both"):
            static = branch(output, target, "static", sta_w)
        total = d_coe * dynamic + s_coe * static
        return total, {"total_loss": total, "dynamic_loss": dynamic,
                       "static_loss": static}

    return loss_fn
