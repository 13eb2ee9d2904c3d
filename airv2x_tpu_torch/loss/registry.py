"""Loss registry (counterpart of airv2x_tpu/loss/registry.py)."""

from __future__ import annotations

from typing import Callable

LOSS_REGISTRY: dict[str, Callable] = {}


def register_loss(*names: str):
    def deco(fn):
        for n in names:
            LOSS_REGISTRY[n] = fn
        return fn

    return deco


def build_loss(hypes: dict):
    """The loss fn ``(output, labels) -> (total, parts)`` of the config's
    task: ``hypes['loss'][task]`` when the config keys its losses by task
    (det / seg), else ``hypes['loss']`` itself."""
    loss_cfg = hypes["loss"]
    task = hypes["model"]["args"].get("task", "det")
    cfg = loss_cfg[task] if task in loss_cfg else loss_cfg
    name = cfg["core_method"]
    if name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss '{name}'; known: {sorted(LOSS_REGISTRY)}")
    return LOSS_REGISTRY[name](cfg["args"])
