"""Training CLI (counterpart of airv2x_tpu/tools/train.py).

    python -m airv2x_tpu_torch.tools.train --hypes_yaml <cfg>
        [--model_dir <run dir to resume>] [--epochs N] [--steps_per_epoch N]
        [--batch_size N] [--grad_accum N] [--seed N] [--device cuda|cpu]

Trains the configured model on synthetic anchor-labelled LiDAR scenes
(``data/synthetic.py:make_batch``), one optimizer update per batch, with the
reference's run-dir layout: ``<log_dir>/<name>__<stamp>/config.yaml``, a
checkpoint ``net_epoch{N}`` per saved epoch, ``train_loss.txt`` and
``validation_loss.txt``. ``--model_dir`` resumes from the last checkpoint of
that run dir, with its ``config.yaml``.

The real dataset loaders are not ported: when the config's ``root_dir``
exists on disk the CLI raises instead of training on synthetic scenes there.
Radar and camera configs raise too (the synthetic batches are LiDAR only).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_batch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import AGENT_TYPES, SlotLayout
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_eval_step, make_optimizer, make_train_step)
from airv2x_tpu_torch.utils.checkpoint import (
    find_last_epoch, load_checkpoint, save_checkpoint, setup_train_dir)
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import init_flax_like_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="airv2x_tpu_torch training")
    p.add_argument("--hypes_yaml", type=str, required=True)
    p.add_argument("--model_dir", type=str, default="", help="resume dir")
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--epochs", type=int, default=0, help="override epoches")
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--grad_accum", type=int, default=0,
        help="microbatches per optimizer step; 0 = auto: microbatches of 2 "
        "whenever the batch is an even number > 2 (resolve_grad_accum)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def resolve_grad_accum(flag: int, batch_size: int) -> int:
    """0 (auto) -> microbatches of 2 when the batch is an even number > 2,
    the JAX package's rule; any explicit value passes through."""
    if flag:
        return flag
    return batch_size // 2 if batch_size > 2 and batch_size % 2 == 0 else 1


def synthetic_batches(hypes, layout, batch_size, steps, seed, device="cuda"):
    """Anchor-labelled synthetic LiDAR batches (numpy), their labels computed
    on ``device``; seg configs get rasterized seg labels."""
    core = hypes["model"]["core_method"].lower()
    if any(k in core for k in ("l4dr", "lrf", "interf", "mdd")):
        raise NotImplementedError("radar configs are not ported")
    margs = hypes["model"]["args"]
    if any(isinstance(margs.get(t), dict)
           and "cam" in margs[t].get("modalities", []) for t in AGENT_TYPES):
        raise NotImplementedError("camera configs are not ported")
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    standup = anchor_standup_boxes(anchors)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        batch, _ = make_batch(
            rng, layout, batch_size=batch_size, anchors=anchors,
            anchor_standup=standup,
            target_args=hypes["postprocess"]["target_args"],
            seg_hw=int(hypes.get("seg_hw", 0)) if hypes.get("task") == "seg" else 0,
            seg_res=float(hypes.get("seg_res", 0.25)),
            device=device,
            num_objects=10,
            points_per_agent=int(hypes["preprocess"].get("max_points", 8192)),
            lidar_range=hypes["preprocess"]["cav_lidar_range"],
            max_boxes=hypes["postprocess"]["max_num"],
        )
        yield batch


def main(argv=None) -> str:
    """Run the training loop; returns the run dir."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    snapshot = os.path.join(opt.model_dir, "config.yaml") if opt.model_dir else ""
    hypes = load_yaml(snapshot if os.path.isfile(snapshot) else opt.hypes_yaml)
    root = hypes.get("root_dir") or ""
    if os.path.isdir(root):
        raise NotImplementedError(
            f"root_dir {root!r} exists, but the real AirV2X loaders are not "
            "ported; move it away to train on synthetic scenes")
    tp = hypes["train_params"]
    epochs = opt.epochs or int(tp["epoches"])
    batch_size = opt.batch_size or int(tp["batch_size"])
    accum = resolve_grad_accum(opt.grad_accum, batch_size)
    steps_per_epoch = opt.steps_per_epoch or int(tp.get("steps_per_epoch", 50))
    save_freq = int(tp.get("save_freq", 1))
    eval_freq = int(tp.get("eval_freq", 2))
    print(f"training on synthetic scenes on {dev}; grad_accum {accum}")

    model = init_flax_like_(build_model(hypes, device=dev, train=True), opt.seed)
    layout = SlotLayout.from_args(hypes["model"]["args"])
    loss_fn = build_loss(hypes)
    optimizer, sched = make_optimizer(hypes, model.parameters(), steps_per_epoch)
    state = TrainState(model, optimizer)

    if opt.model_dir:
        run_dir = opt.model_dir
        start_epoch = find_last_epoch(run_dir)
        if start_epoch:
            load_checkpoint(run_dir, start_epoch, state)
            print(f"resumed from epoch {start_epoch}")
    else:
        run_dir = setup_train_dir(hypes, opt.log_dir)
        start_epoch = 0
    print(f"run dir: {run_dir}")

    train_step = make_train_step(loss_fn, sched, accum_steps=accum,
                                 compute_dtype=compute_dtype(hypes),
                                 seed=opt.seed)
    eval_step = make_eval_step(loss_fn)
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        losses = []
        for batch in synthetic_batches(hypes, layout, batch_size,
                                       steps_per_epoch, opt.seed + epoch + 1,
                                       device=dev):
            parts = train_step(state, batch_to_torch(batch, dev))
            losses.append({k: float(v) for k, v in parts.items()})
        means = {k: float(np.mean([p[k] for p in losses])) for k in losses[0]}
        msg = (f"epoch {epoch + 1}/{epochs} "
               + " ".join(f"{k}: {v:.3f}" for k, v in sorted(means.items()))
               + f" ({time.time() - t0:.1f}s)")
        print(msg)
        with open(os.path.join(run_dir, "train_loss.txt"), "a") as f:
            f.write(msg + "\n")

        if (epoch + 1) % save_freq == 0:
            save_checkpoint(run_dir, epoch + 1, state)

        if (epoch + 1) % eval_freq == 0:
            val = [float(eval_step(model, batch_to_torch(b, dev))[1])
                   for b in synthetic_batches(hypes, layout, batch_size,
                                              max(steps_per_epoch // 5, 1),
                                              777, device=dev)]
            line = f"epoch: {epoch + 1}, loss: {float(np.mean(val)):.4f}"
            print("val", line)
            with open(os.path.join(run_dir, "validation_loss.txt"), "a") as f:
                f.write(line + "\n")

    print("training finished; run dir:", run_dir)
    return run_dir


if __name__ == "__main__":
    main()
