"""Model registry (counterpart of airv2x_tpu/models/registry.py): one entry
for slice 1, the flagship Where2comm detector."""

from __future__ import annotations

from airv2x_tpu_torch.models.where2comm_model import Airv2xWhere2comm
from airv2x_tpu_torch.utils.device import resolve_device

MODEL_REGISTRY = {"airv2x_where2comm": Airv2xWhere2comm}


def build_model(hypes: dict, *, device="cuda"):
    """Build the eval-mode float32 model named by
    ``hypes['model']['core_method']`` on ``device``.

    The model args also carry the preprocess / postprocess sections. Raises
    when ``device`` is CUDA and no card is present.
    """
    dev = resolve_device(device)
    name = hypes["model"]["core_method"]
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; known: {sorted(MODEL_REGISTRY)}")
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    args.setdefault("postprocess", hypes.get("postprocess"))
    model = MODEL_REGISTRY[name](args)
    return model.to(dev).eval().requires_grad_(False)
