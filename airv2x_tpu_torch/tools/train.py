"""Training CLI (counterpart of airv2x_tpu/tools/train.py).

    python -m airv2x_tpu_torch.tools.train --hypes_yaml <cfg>
        [--model_dir <run dir to resume>] [--epochs N] [--steps_per_epoch N]
        [--batch_size N] [--grad_accum N] [--seed N] [--num_workers N]
        [--synthetic] [--half] [--device cuda|cpu]

When the config's ``root_dir`` exists on disk it trains on that AirV2X
split (``data/airv2x_dataset.py`` through ``data/loader.py``: prefetch
workers, the config's wild settings, anchor labels on the device) and
computes the validation loss on ``validate_dir`` (the train split, in
order, when that is absent); otherwise, or with ``--synthetic``, on
synthetic anchor-labelled LiDAR scenes (``data/synthetic.py:make_batch``),
with each camera config's per-type camera stacks added per sample
(``add_camera_inputs``, as the JAX CLI adds them). Every model the port
serves trains, camera configs included (on disk their ``data_aug_conf``
must give the AirV2X augmentation keys, which the shipped camera YAMLs
lack). One optimizer update per batch, with the reference's run-dir layout:
``<log_dir>/<name>__<stamp>/config.yaml``, a checkpoint ``net_epoch{N}``
per saved epoch, ``train_loss.txt`` and ``validation_loss.txt``.
``--model_dir`` resumes from the last checkpoint of that run dir, with its
``config.yaml``. ``--half`` is accepted and read nowhere, as in the JAX
CLI. The LiDAR + 4D-radar models (``needs_radar``: MDD among them, RTNH
not, as the JAX CLI decides) get a radar cloud of ``max_points // 8``
points per agent on synthetic scenes, as the JAX CLI draws it; RTNH reads
the LiDAR cloud where a batch has no radar (ROADMAP §3). Every batch's
labels carry ``epoch``, the 1-based epoch (MDD's loss schedules its term by
it), as in the JAX CLI. A radar-only AdaFusion config and a BM2CP config
without a dataset raise before anything is built (the JAX CLI cannot train
either on synthetic scenes).
"""

from __future__ import annotations

import argparse
import os
import time
from itertools import islice

import numpy as np

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset, WildSettings
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.data.synthetic import (
    add_camera_batch, batch_to_torch, make_batch)
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
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
    p.add_argument("--half", action="store_true",
                   help="accepted for the JAX CLI's command lines and, as "
                   "there, read nowhere: compute follows the config's dtype")
    p.add_argument(
        "--grad_accum", type=int, default=0,
        help="microbatches per optimizer step; 0 = auto: microbatches of 2 "
        "whenever the batch is an even number > 2 (resolve_grad_accum)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="prefetch workers of the real-data loader")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic scenes even where root_dir exists")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def resolve_grad_accum(flag: int, batch_size: int) -> int:
    """0 (auto) -> microbatches of 2 when the batch is an even number > 2,
    the JAX package's rule; any explicit value passes through."""
    if flag:
        return flag
    return batch_size // 2 if batch_size > 2 and batch_size % 2 == 0 else 1


def build_real_loaders(hypes, opt, batch_size, device):
    """(train loader, validation loader or None) over the config's
    ``root_dir`` and ``validate_dir``, or None when ``root_dir`` is absent,
    empty or ``--synthetic`` is set."""
    root = hypes.get("root_dir") or ""
    if opt.synthetic or not os.path.isdir(root):
        return None
    wild_cfg = hypes.get("wild_setting", {}) or {}
    wild = WildSettings(
        async_mode=bool(wild_cfg.get("async", False)),
        async_overhead_ms=float(wild_cfg.get("async_overhead", 100)),
        loc_error=bool(wild_cfg.get("loc_err", False)),
        xyz_std=float(wild_cfg.get("xyz_std", 0.2)),
        ryp_std=float(wild_cfg.get("ryp_std", 0.2)),
    )
    train_ds = AirV2XDataset(hypes, root, train=True, wild=wild, seed=opt.seed)
    if len(train_ds) == 0:
        return None
    kw = dict(seed=opt.seed, num_workers=opt.num_workers, device=device)
    train_loader = RealDataLoader(train_ds, hypes, batch_size, train=True, **kw)
    val_loader = None
    vdir = hypes.get("validate_dir") or ""
    if os.path.isdir(vdir):
        val_ds = AirV2XDataset(hypes, vdir, train=False, seed=opt.seed)
        if len(val_ds):
            val_loader = RealDataLoader(val_ds, hypes, batch_size, train=False,
                                        drop_last=len(val_ds) >= batch_size,
                                        **kw)
    return train_loader, val_loader


def needs_radar(hypes) -> bool:
    """Whether the model reads a radar cloud, by its name as the JAX CLIs
    decide it (``l4dr``, ``lrf``, ``interf``, ``mdd``): those get
    ``max_points // 8`` radar points per agent on synthetic scenes."""
    core = hypes["model"]["core_method"].lower()
    return any(k in core for k in ("l4dr", "lrf", "interf", "mdd"))


def refuse_on_synthetic(hypes) -> None:
    """Raise NotImplementedError for a config the port cannot train on
    synthetic scenes: a radar-only SpatialCooper / PFA-Net (``use_modality:
    processed_radar`` among the model args, ``4DRadar/V2XR_adafusion.yaml``),
    whose name the JAX CLI's ``needs_radar`` leaves out, so its batches
    carry no radar cloud for the model to read, and BM2CP, which cannot
    train there in the JAX CLI either (ROADMAP §3)."""
    core = hypes["model"]["core_method"].lower()
    radar_only = (str(hypes["model"]["args"].get("use_modality", ""))
                  == "processed_radar")
    if radar_only and not needs_radar(hypes):
        raise NotImplementedError(
            "this config encodes the radar cloud (model.args.use_modality: "
            "processed_radar), but synthetic scenes carry radar points only "
            "for the l4dr / lrf / interf / mdd models, as the JAX CLI draws "
            "them: it trains and serves on a V2X-R dataset (ROADMAP §3)")
    if "bm2cp" in core:
        raise NotImplementedError(
            "BM2CP trains on a dataset only: the synthetic batches carry no "
            "camera blocks for it (its config gives no agent type the cam "
            "modality) and no depth_maps, which BM2CP reads; the JAX CLI's "
            "synthetic_batches builds the same batches, and its first step "
            "fails on the missing cam_<type> inputs (ROADMAP §3)")


def synthetic_batches(hypes, layout, batch_size, steps, seed, device="cuda"):
    """Anchor-labelled synthetic LiDAR batches (numpy), their labels computed
    on ``device``; seg configs get rasterized seg labels, camera configs the
    per-type camera stacks at the first camera type's ``final_dim``, drawn
    per sample after its scene (the JAX CLI's order)."""
    refuse_on_synthetic(hypes)
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
            radar_points_per_agent=(
                int(hypes["preprocess"].get("max_points", 8192)) // 8
                if needs_radar(hypes) else 0),
        )
        yield add_camera_batch(batch, hypes, layout, rng)


def main(argv=None) -> str:
    """Run the training loop; returns the run dir."""
    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml, opt.model_dir or None)
    tp = hypes["train_params"]
    epochs = opt.epochs or int(tp["epoches"])
    batch_size = opt.batch_size or int(tp["batch_size"])
    accum = resolve_grad_accum(opt.grad_accum, batch_size)
    save_freq = int(tp.get("save_freq", 1))
    eval_freq = int(tp.get("eval_freq", 2))
    loaders = build_real_loaders(hypes, opt, batch_size, dev)
    if loaders is not None:
        train_loader, val_loader = loaders
        steps_per_epoch = opt.steps_per_epoch or len(train_loader)
        print(f"training on the dataset at {hypes['root_dir']} on {dev}: "
              f"{len(train_loader.dataset)} train samples, "
              + (f"{len(val_loader.dataset)} val samples" if val_loader
                 else "no validate_dir") + f"; grad_accum {accum}")
    else:
        refuse_on_synthetic(hypes)
        train_loader = val_loader = None
        steps_per_epoch = opt.steps_per_epoch or int(tp.get("steps_per_epoch", 50))
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
        if train_loader is not None:
            # --steps_per_epoch also cut the schedule to this length
            epoch_iter = islice(train_loader.batches(epoch=epoch), steps_per_epoch)
        else:
            epoch_iter = (batch_to_torch(b, dev) for b in synthetic_batches(
                hypes, layout, batch_size, steps_per_epoch, opt.seed + epoch + 1,
                device=dev))
        for batch in epoch_iter:
            # epoch-scheduled loss terms (point_pillar_loss_mdd) read it
            batch["labels"]["epoch"] = float(epoch + 1)
            parts = train_step(state, batch)
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
            if val_loader is not None:
                val_iter = val_loader.batches(epoch=0)
            elif train_loader is not None:  # no validate_dir: the train split
                val_iter = train_loader.batches(epoch=0)
            else:
                val_iter = (batch_to_torch(b, dev) for b in synthetic_batches(
                    hypes, layout, batch_size, max(steps_per_epoch // 5, 1), 777,
                    device=dev))
            val = [float(eval_step(model, b)[1]) for b in val_iter]
            line = f"epoch: {epoch + 1}, loss: {float(np.mean(val)):.4f}"
            print("val", line)
            with open(os.path.join(run_dir, "validation_loss.txt"), "a") as f:
                f.write(line + "\n")

    print("training finished; run dir:", run_dir)
    return run_dir


if __name__ == "__main__":
    main()
