"""Checkpoint save / resume with the reference's run-dir layout (counterpart
of airv2x_tpu/utils/checkpoint.py, ``torch.save`` in place of orbax).

A run dir ``<base>/<name>__<stamp>/`` holds a ``config.yaml`` snapshot and
one checkpoint per saved epoch, ``net_epoch{N}``: the model's
``state_dict``, the optimizer's and the count of updates made, so that a
resumed run continues the schedule and the Adam moments where they were.
"""

from __future__ import annotations

import os
import re
from datetime import datetime

import torch

from airv2x_tpu_torch.config import save_yaml


def setup_train_dir(hypes: dict, base_dir: str = "logs") -> str:
    name = hypes.get("name", "experiment")
    stamp = datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    run_dir = os.path.join(base_dir, f"{name}__{stamp}")
    os.makedirs(run_dir, exist_ok=True)
    save_yaml(hypes, os.path.join(run_dir, "config.yaml"))
    return run_dir


def _ckpt_path(run_dir: str, epoch: int) -> str:
    return os.path.join(run_dir, f"net_epoch{epoch}")


def save_checkpoint(run_dir: str, epoch: int, state) -> None:
    """Save a ``parallel.train.TrainState`` as epoch ``epoch``."""
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, _ckpt_path(run_dir, epoch))


def find_last_epoch(run_dir: str) -> int:
    """Latest saved epoch index, 0 if none (reference findLastCheckPoint)."""
    if not os.path.isdir(run_dir):
        return 0
    epochs = [
        int(m.group(1))
        for f in os.listdir(run_dir)
        if (m := re.match(r"net_epoch(\d+)$", f))
    ]
    return max(epochs, default=0)


def load_checkpoint(run_dir: str, epoch: int, state):
    """Restore epoch ``epoch`` into ``state`` (model, optimizer, step) in
    place, onto the model's device; returns ``state``."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(_ckpt_path(run_dir, epoch), map_location=dev,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state
