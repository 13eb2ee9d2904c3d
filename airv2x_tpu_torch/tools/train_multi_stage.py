"""Multi-stage (HEAL / STAMP) collaborative training CLI (counterpart of
airv2x_tpu/tools/train_multi_stage.py).

    python -m airv2x_tpu_torch.tools.train_multi_stage --hypes_yaml <collab cfg>
        [--drone_dir <run>] [--rsu_dir <run>] [--vehicle_dir <run>]
        [--log_dir logs] [--epochs N] [--steps_per_epoch N] [--batch_size N]
        [--seed N] [--device cuda|cpu]

Stage 1 trains one model per agent type on its ``single/<type>.yaml``
(``tools/train.py``). Stage 2 builds the collab model, loads the stage-1
run dirs (each at its best epoch, ``find_best_epoch``) in the order drone,
rsu, vehicle, so that the vehicle's weights win where the types share a
module, copying each tensor whose name and shape match
(``merge_compatible``; the rest keep their initialisation), freezes what
``model.args.backbone_fix`` names (``parallel/train.py:freeze_by_path``),
and trains the rest on synthetic scenes, as the JAX CLI does, saving a
checkpoint per epoch into a new run dir. The run dirs are the port's own
(``torch.save``, as ``tools/train.py`` writes them).
"""

from __future__ import annotations

import argparse

import numpy as np

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.parallel.train import (
    TrainState, backbone_fix_prefixes, freeze_by_path, make_optimizer,
    make_train_step, trainable_parameters)
from airv2x_tpu_torch.tools.train import synthetic_batches
from airv2x_tpu_torch.utils.checkpoint import (
    find_best_epoch, load_model_weights, save_checkpoint, setup_train_dir)
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import init_flax_like_

STAGE1_ORDER = ("drone", "rsu", "vehicle")  # the ego type's weights last


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="HEAL / STAMP stage-2 training")
    p.add_argument("--hypes_yaml", type=str, required=True)
    for t in STAGE1_ORDER:
        p.add_argument(f"--{t}_dir", type=str, default="")
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def merge_compatible(target: dict, source: dict) -> list:
    """Copy into the state dict ``target`` (in place) every tensor of
    ``source`` whose name and shape match; returns the copied names."""
    copied = []
    for k, v in source.items():
        if k in target and target[k].shape == v.shape:
            target[k].copy_(v)
            copied.append(k)
    return copied


def load_stage1(model, run_dir: str, device) -> list:
    """Merge the stage-1 run dir's best epoch into ``model``; returns the
    names copied."""
    src_hypes = load_yaml(None, run_dir)
    src = init_flax_like_(build_model(src_hypes, device=device), 0)
    epoch = find_best_epoch(run_dir)
    if epoch:
        load_model_weights(run_dir, epoch, src)
    target = model.state_dict()
    return merge_compatible(target, src.state_dict())


def main(argv=None) -> str:
    """Run stage 2; returns its run dir."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml)
    tp = hypes["train_params"]
    epochs = opt.epochs or int(tp["epoches"])
    batch_size = opt.batch_size or int(tp["batch_size"])
    steps_per_epoch = opt.steps_per_epoch or int(tp.get("steps_per_epoch", 50))

    model = init_flax_like_(build_model(hypes, device=dev, train=True), opt.seed)
    params = {n for n, _ in model.named_parameters()}
    for t in STAGE1_ORDER:
        run_dir = getattr(opt, f"{t}_dir")
        if run_dir:
            copied = load_stage1(model, run_dir, dev)
            n = sum(k in params for k in copied)
            m = sum(k not in params and not k.endswith("num_batches_tracked")
                    for k in copied)
            print(f"loaded {t} stage-1 checkpoint: {n} params, {m} stats "
                  "leaves")
    frozen = backbone_fix_prefixes(hypes["model"]["args"])
    if frozen:
        names = freeze_by_path(model, frozen)
        print(f"freezing {frozen}: {len(names)} parameters")

    layout = SlotLayout.from_args(hypes["model"]["args"])
    optimizer, sched = make_optimizer(hypes, trainable_parameters(model),
                                      steps_per_epoch)
    state = TrainState(model, optimizer)
    run_dir = setup_train_dir(hypes, opt.log_dir)
    step = make_train_step(build_loss(hypes), sched,
                           compute_dtype=compute_dtype(hypes), seed=opt.seed)
    for epoch in range(epochs):
        losses = [float(step(state, batch_to_torch(b, dev))["total_loss"])
                  for b in synthetic_batches(hypes, layout, batch_size,
                                             steps_per_epoch,
                                             opt.seed + epoch + 1, device=dev)]
        print(f"epoch {epoch + 1}/{epochs} loss {np.mean(losses):.3f}")
        save_checkpoint(run_dir, epoch + 1, state)
    print("stage-2 training finished:", run_dir)
    return run_dir


if __name__ == "__main__":
    main()
