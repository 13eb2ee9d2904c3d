"""Loss variants (counterpart of airv2x_tpu/loss/variants.py): SiCP's dual
supervision and STAMP's adapter alignment.

``point_pillar_loss_sicp_multiclass`` / ``point_pillar_loss_sicp``: the
multiclass loss where the config gives ``num_class`` (AirV2X), else the
binary one (the flat OPV2V family); on an output with SiCP's train-mode
heads (``psm1`` ...) it sums the single-agent and the cooperative heads'
losses, otherwise it is the base loss.

``adapter_loss``: L1 means between translated maps, each term only where
the output carries both its maps (FM: ``adapted`` against ``protocol``;
P2M: ``reverted`` against ``ego_feature``; FP2M: ``cycled`` against
``ego_feature``), weighted by ``fm`` / ``p2m`` / ``fp2m``. No ported model
emits those keys (STAMP's forward neither, in either package), so on every
model the loss is 0.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.loss.point_pillar_binary import make_binary_loss
from airv2x_tpu_torch.loss.point_pillar_multiclass import make_multiclass_loss
from airv2x_tpu_torch.loss.registry import register_loss


@register_loss("point_pillar_loss_sicp_multiclass", "point_pillar_loss_sicp")
def make_sicp_loss(args: dict):
    base = (make_multiclass_loss(args) if "num_class" in args
            else make_binary_loss(args))

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        if "psm1" in output:
            t1, p1 = base(output, target, prefix="1")
            t2, p2 = base(output, target, prefix="2")
            total = t1 + t2
            return total, {"total_loss": total, **p1, **p2}
        return base(output, target, prefix)

    return loss_fn


@register_loss("adapter_loss")
def make_adapter_loss(args: dict):
    weights = {"fm": float(args.get("fm", 1.0)),
               "p2m": float(args.get("p2m", 1.0)),
               "fp2m": float(args.get("fp2m", 1.0))}
    terms = (("fm", "adapted", "protocol"), ("p2m", "reverted", "ego_feature"),
             ("fp2m", "cycled", "ego_feature"))

    def loss_fn(output: dict, target: dict, prefix: str = ""):
        total = torch.zeros((), dtype=torch.float32)
        parts = {}
        for name, a, b in terms:
            if a in output and b in output:
                term = (output[a].float() - output[b].float()).abs().mean()
                total = total.to(term.device) + weights[name] * term
                parts[f"{name}_loss"] = term
        parts["total_loss"] = total
        return total, parts

    return loss_fn
