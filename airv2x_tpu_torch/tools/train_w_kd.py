"""Knowledge-distillation training (counterpart of
airv2x_tpu/tools/train_w_kd.py).

    python -m airv2x_tpu_torch.tools.train_w_kd --hypes_yaml <student cfg>
        --teacher_dir <teacher run dir> [--log_dir logs] [--epochs N]
        [--steps_per_epoch N] [--batch_size N] [--seed N] [--device cuda|cpu]

The teacher is the model of a run dir written by the port's train CLI (its
``config.yaml`` and its best epoch; seeded flax-like weights, with a
warning, when it holds no checkpoint), frozen, in eval mode and without
gradients. Each step runs the student in train mode and the teacher on the
same batch (``DistilledStudent``), gives the config's loss the student's
``student_feature`` and the teacher's ``teacher_feature`` (both NHWC) and
updates the student only (``make_train_step``: AdamW, the config's
schedule, bf16 autocast where the config computes in bf16). Where the two
features' channels differ, both fall back to the cls logits, as in the JAX
tool. The KD term is the loss's: ``point_pillar_disconet_loss`` adds it,
and the shipped ``*_disconet.yaml`` name ``point_pillar_loss``, which does
not (ROADMAP §3). Synthetic anchor-labelled scenes, as the JAX tool; a
checkpoint of the student per epoch in a new run dir.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch import nn

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step)
from airv2x_tpu_torch.tools.train import synthetic_batches
from airv2x_tpu_torch.utils.checkpoint import (
    find_best_epoch, load_model_weights, save_checkpoint, setup_train_dir)
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import init_flax_like_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="airv2x_tpu_torch KD training")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--teacher_dir", required=True)
    p.add_argument("--log_dir", default="logs")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


class DistilledStudent(nn.Module):
    """The student with a frozen teacher beside it: ``forward(batch)`` is
    the student's outputs plus ``teacher_feature`` (the teacher's, computed
    without gradients in eval mode); ``train()`` leaves the teacher in
    eval mode. Only the student's parameters are the optimizer's."""

    def __init__(self, student: nn.Module, teacher: nn.Module):
        super().__init__()
        self.student = student
        self.teacher = teacher.eval().requires_grad_(False)

    def train(self, mode: bool = True):
        super().train(mode)
        self.teacher.eval()
        return self

    def forward(self, batch):
        out = dict(self.student(batch))
        with torch.no_grad():
            t_out = self.teacher(batch)
        out.setdefault("student_feature", out["psm"])
        t_feat = t_out.get("teacher_feature", t_out.get("psm"))
        if t_feat.shape[-1] != out["student_feature"].shape[-1]:
            t_feat = t_out.get("teacher_psm", t_out.get("psm"))
            out["student_feature"] = out["psm"]
        out["teacher_feature"] = t_feat.detach()
        return out


def load_teacher(teacher_dir: str, device, seed: int = 2) -> nn.Module:
    """The frozen eval-mode teacher of a port run dir: its best epoch's
    weights, or seeded flax-like weights when it has no checkpoint."""
    hypes = load_yaml(None, teacher_dir)
    teacher = build_model(hypes, device=device)
    epoch = find_best_epoch(teacher_dir)
    if epoch:
        load_model_weights(teacher_dir, epoch, teacher)
        print(f"teacher epoch {epoch} loaded (frozen)")
    else:
        init_flax_like_(teacher, seed)
        print("WARNING: the teacher run dir holds no checkpoint; random teacher")
    return teacher


def main(argv=None) -> dict:
    """Run the KD training; returns the student's ``run_dir``, each step's
    loss ``parts`` and its host ``step_ms`` (the device synchronised)."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml)
    tp = hypes["train_params"]
    epochs = opt.epochs or int(tp["epoches"])
    batch_size = opt.batch_size or int(tp["batch_size"])
    steps_per_epoch = opt.steps_per_epoch or int(tp.get("steps_per_epoch", 50))

    student = init_flax_like_(build_model(hypes, device=dev, train=True), opt.seed)
    model = DistilledStudent(student, load_teacher(opt.teacher_dir, dev))
    layout = SlotLayout.from_args(hypes["model"]["args"])
    optimizer, sched = make_optimizer(hypes, student.parameters(), steps_per_epoch)
    state = TrainState(model, optimizer)
    step = make_train_step(build_loss(hypes), sched,
                           compute_dtype=compute_dtype(hypes), seed=opt.seed)
    run_dir = setup_train_dir(hypes, opt.log_dir)
    cuda = dev.type == "cuda"
    all_parts, step_ms = [], []
    for epoch in range(epochs):
        losses = []
        for batch in synthetic_batches(hypes, layout, batch_size, steps_per_epoch,
                                       opt.seed + epoch + 1, device=dev):
            batch = batch_to_torch(batch, dev)
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            parts = {k: float(v) for k, v in step(state, batch).items()}
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            all_parts.append(parts)
            losses.append(parts["total_loss"])
        print(f"epoch {epoch + 1}/{epochs} loss {np.mean(losses):.3f}")
        save_checkpoint(run_dir, epoch + 1,
                        TrainState(student, optimizer, state.step))
    print("KD training finished:", run_dir)
    return {"run_dir": run_dir, "parts": all_parts, "step_ms": step_ms}


if __name__ == "__main__":
    main()
