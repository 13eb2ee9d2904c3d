"""Training step factory (counterpart of airv2x_tpu/parallel/train.py):
the learning-rate schedule and the optimizer from the hypes, the train step
with gradient accumulation, and the eval step.

The JAX package's optax transforms map onto torch optimizers: ``adamw``
(decoupled decay, every parameter decayed, BN scale and bias included) is
``torch.optim.AdamW`` with the config's ``weight_decay`` passed explicitly;
``adam`` is AdamW with no decay (the JAX package's ``sgd``, which no config
names, is not ported). optax
evaluates the schedule at the count of updates already made (0 for the
first), so the train step sets each update's learning rate from the same
function at that count, never with an epoch-stepped torch scheduler.

Parameters and optimizer state stay f32 (the master weights); with a bf16
compute dtype the forward runs under ``torch.autocast``, as the JAX
package keeps f32 parameters and computes in its module dtype.

``backbone_fix`` (the multi-stage recipe of HEAL and STAMP) freezes
parameters by their flax path, as the JAX package's ``freeze_by_path``
labels them for ``optax.set_to_zero``: ``freeze_by_path`` takes them out of
the gradient and the optimizer is built over the rest, so a frozen
parameter gets no update and no weight decay, while a frozen module's BN
statistics still update in train mode, as flax's ``batch_stats`` do.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from airv2x_tpu_torch.utils.weights import flax_paths


def make_lr_schedule(hypes: dict, steps_per_epoch: int) -> Callable[[int], float]:
    """Step-indexed learning rate of the reference's epoch schedulers:
    ``multistep`` (scaled by gamma once the step count reaches each
    boundary, boundaries = epochs x steps_per_epoch), ``step``,
    ``exponential``, ``cosineannealwarm`` (linear warm-up, then cosine decay
    to ``lr_min``), else constant."""
    opt_cfg = hypes["optimizer"]
    sched_cfg = hypes.get("lr_scheduler", {})
    base_lr = float(opt_cfg["lr"])
    method = sched_cfg.get("core_method", "constant")
    if method == "multistep":
        gamma = float(sched_cfg["gamma"])
        bounds = sorted(int(e) * steps_per_epoch for e in sched_cfg["step_size"])
        return lambda step: base_lr * gamma ** sum(step >= b for b in bounds)
    if method == "step":
        gamma = float(sched_cfg["gamma"])
        every = int(sched_cfg["step_size"]) * steps_per_epoch
        return lambda step: base_lr * gamma ** (step // every)
    if method in ("exponential", "Exponential"):
        gamma = float(sched_cfg.get("gamma", 0.98))
        return lambda step: base_lr * gamma ** (step / steps_per_epoch)
    if method == "cosineannealwarm":
        warmup_lr = float(sched_cfg["warmup_lr"])
        lr_min = float(sched_cfg["lr_min"])
        warmup = max(int(sched_cfg["warmup_epoches"]) * steps_per_epoch, 1)
        total = max(int(sched_cfg["epoches"]) * steps_per_epoch, 2)
        alpha = 0.0 if base_lr == 0.0 else lr_min / base_lr

        def cosine(step):
            if step < warmup:
                return warmup_lr + (base_lr - warmup_lr) * step / warmup
            t = min(step - warmup, total - warmup)
            decay = 0.5 * (1 + math.cos(math.pi * t / (total - warmup)))
            return base_lr * ((1 - alpha) * decay + alpha)

        return cosine
    return lambda step: base_lr


def make_optimizer(hypes: dict, params, steps_per_epoch: int = 1):
    """(optimizer over ``params``, schedule). The optimizer's lr is set per
    update by the train step."""
    opt_cfg = hypes["optimizer"]
    sched = make_lr_schedule(hypes, steps_per_epoch)
    args = opt_cfg.get("args", {})
    wd = float(args.get("weight_decay", 0.0))
    eps = float(args.get("eps", 1e-8))
    if opt_cfg.get("core_method", "Adam").lower() != "adam":
        raise NotImplementedError(
            f"optimizer {opt_cfg['core_method']} is not ported (every config "
            "in the repo names Adam)")
    return torch.optim.AdamW(params, lr=sched(0), eps=eps, weight_decay=wd), sched


def backbone_fix_prefixes(args: dict) -> list:
    """The flax scope prefixes ``args['backbone_fix']`` freezes: true ->
    the encoders, backbone, shrink and heads; a list of agent types ->
    those types' pillar encoders; false or absent -> none."""
    fix = args.get("backbone_fix")
    if not fix:
        return []
    if isinstance(fix, bool):
        return ["encoder", "backbone", "shrink_conv", "heads", "seg_head"]
    return [f"{t}_pillar_vfe" for t in fix]


def freeze_by_path(model: nn.Module, frozen_prefixes) -> list:
    """Freeze every parameter of ``model`` one of whose flax path's parts
    (through the weight bridge's name map, ``utils/weights.py:flax_paths``)
    starts with one of ``frozen_prefixes``: it stops requiring a gradient,
    and an optimizer built over ``trainable_parameters(model)`` leaves it
    as it is. Returns the frozen parameters' names."""
    paths = flax_paths(model)
    frozen = []
    for name, p in model.named_parameters():
        if any(str(part).startswith(pre) for part in paths[name][1:]
               for pre in frozen_prefixes):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def trainable_parameters(model: nn.Module) -> list:
    return [p for p in model.parameters() if p.requires_grad]


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of updates made."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def split_batch(batch: dict, parts: int) -> list[dict]:
    """``parts`` microbatches of a (nested) batch dict: every tensor whose
    leading dim is the batch size is split along it, the rest rides along
    whole (as the JAX step's scan carries unbatched leaves)."""
    b = batch["points"].shape[0]
    if b % parts:
        raise ValueError(f"batch {b} not divisible by accum_steps {parts}")
    mb = b // parts

    def take(v, i):
        if isinstance(v, dict):
            return {k: take(x, i) for k, x in v.items()}
        if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == b:
            return v[i * mb:(i + 1) * mb]
        return v

    return [take(batch, i) for i in range(parts)]


def make_train_step(loss_fn: Callable, sched: Callable[[int], float], *,
                    accum_steps: int = 1,
                    compute_dtype: torch.dtype = torch.float32, seed: int = 0):
    """Build ``step(state, batch, comm_u=None) -> parts`` for any model of
    the registry.

    One update per call: the learning rate ``sched(state.step)``, then the
    ``accum_steps`` microbatches run in order (BN statistics update per
    microbatch, as the JAX step's scan threads them), their gradients and
    loss parts averaged. A model whose class sets ``DRAWS_KEEP_FRACTION``
    (Where2comm's train-mode communication) gets ``comm_u`` and
    ``generator`` keywords: ``comm_u`` (B,) gives the keep fractions of the
    whole batch (microbatch i takes its rows); without it they are drawn
    from a CPU generator seeded by (``seed``, ``state.step``), so a resumed
    run draws what an uninterrupted one would. A model whose class sets
    ``DRAWS_NOISE`` (MDD's diffusion chain) gets that ``generator`` alone.
    Every other model is called as ``model(batch)``, and ``comm_u`` must be
    None. ``parts`` are detached f32 tensors."""

    def step(state: TrainState, batch: dict, comm_u=None):
        model, opt = state.model, state.optimizer
        draws = getattr(model, "DRAWS_KEEP_FRACTION", False)
        if comm_u is not None and not draws:
            raise ValueError(f"{type(model).__name__} draws no keep fraction")
        model.train()
        lr = sched(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.zero_grad(set_to_none=True)
        generator = torch.Generator().manual_seed((seed << 32) + state.step)
        micro = split_batch(batch, accum_steps) if accum_steps > 1 else [batch]
        dev = batch["points"].device
        totals: dict = {}
        for i, mb in enumerate(micro):
            kw = {}
            if draws:
                n = mb["points"].shape[0]
                kw = dict(generator=generator, comm_u=None if comm_u is None
                          else comm_u[i * n:(i + 1) * n])
            elif getattr(model, "DRAWS_NOISE", False):
                kw = dict(generator=generator)
            with torch.autocast(dev.type, dtype=compute_dtype,
                                enabled=compute_dtype != torch.float32):
                out = model(mb, **kw)
            total, parts = loss_fn(out, mb["labels"])
            (total / accum_steps).backward()
            for k, v in parts.items():
                totals[k] = totals.get(k, 0.0) + v.detach().float()
        # a parameter the loss does not reach (BM2CP's img_proj, behind a
        # threshold) gets a zero gradient, as in JAX: AdamW then still
        # decays it, where PyTorch would skip a parameter without one
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        state.step += 1
        return {k: v / accum_steps for k, v in totals.items()}

    return step


def make_eval_step(loss_fn: Callable):
    """``eval_step(model, batch) -> (outputs, total, parts)`` in eval mode,
    without gradients."""

    def eval_step(model: nn.Module, batch: dict):
        model.eval()
        with torch.no_grad():
            out = model(batch)
            total, parts = loss_fn(out, batch["labels"])
        return out, total, parts

    return eval_step
