"""Checkpoint save / resume with the reference's run-dir layout (counterpart
of airv2x_tpu/utils/checkpoint.py, ``torch.save`` in place of orbax).

A run dir ``<base>/<name>__<stamp>/`` holds a ``config.yaml`` snapshot and
one checkpoint per saved epoch, ``net_epoch{N}``: the model's
``state_dict``, the optimizer's and the count of updates made, so that a
resumed run continues the schedule and the Adam moments where they were.
``find_best_epoch`` picks the epoch of least validation loss for the
evaluation tools.
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
    ckpt = _read(run_dir, epoch, state.model)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def load_model_weights(run_dir: str, epoch: int, model):
    """Restore only the model of epoch ``epoch`` (for evaluation), onto the
    model's device, in place; returns ``model``."""
    model.load_state_dict(_read(run_dir, epoch, model)["model"])
    return model


def _read(run_dir: str, epoch: int, model) -> dict:
    dev = next(model.parameters()).device
    return torch.load(_ckpt_path(run_dir, epoch), map_location=dev,
                      weights_only=True)


def find_best_epoch(run_dir: str) -> int:
    """The epoch of least loss in the run dir's ``validation_loss.txt``
    among those with a checkpoint, else the latest saved epoch (0 if none)."""
    path = os.path.join(run_dir, "validation_loss.txt")
    if not os.path.isfile(path):
        return find_last_epoch(run_dir)
    best, best_loss = None, float("inf")
    with open(path) as f:
        for line in f:
            m = re.match(r"epoch[: ]+(\d+).*loss[: ]+([0-9.eE+-]+)", line.strip())
            if m:
                e, v = int(m.group(1)), float(m.group(2))
                if v < best_loss and os.path.isfile(_ckpt_path(run_dir, e)):
                    best, best_loss = e, v
    return best if best is not None else find_last_epoch(run_dir)
