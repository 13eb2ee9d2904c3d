"""Probes of full-width training on the card behind the repeated-batch check
of ``chip_smoke.py`` (phases 8, 9 and 17; PERF.md §7), one JSON line each:

  * ``curve``: per config, one seeded model (``chip_smoke.train_setup``:
    batch 2, two batches, flax-like weights) takes PREFIX steps over the
    two batches at the YAML's recipe (bf16 autocast, Adam), then one batch
    REPEATS times in branches from that one state: at the recipe's lr, and
    at a tenth of it. For When2com det also whole runs in f32 (TF32 off),
    at a tenth of the lr, at Adam eps 1e-6 and with the fusion's key and
    query MLPs frozen;
  * ``handshake``: When2com's agent scores (key . query) per sample, at
    the initial weights and after the prefix: a softmax over scores
    further apart than ~100 is one-hot in f32, and then every weight of the
    fusion gets gradient 0;
  * ``grad``: the gradient against the loss, f32, TF32 off, deterministic
    cuDNN: per module (the model's children, and the fusion's), the loss
    after a step along that module's negative gradient sized so that the
    first-order prediction is a fall of FRACS x the loss, over that
    prediction (1 for a gradient that is right, as the step shrinks), at
    the initial weights and after the prefix.

Run it from the repository root on one card (a few minutes):

    PYTHONPATH=. python tests/train_card_probes.py [group/task/name ...]
"""

import copy
import json
import os
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

PREFIX = 8
REPEATS = 16
FRACS = (1e-3, 1e-4)
CONFIGS = ("lidar/det/when2com", "lidar/det/where2comm", "lidar/seg/where2comm",
           "lidar/det/v2xvit", "lidar/det/att_fusion", "lidar/det/max_fusion",
           "lidar/det/cobevt", "lidar/det/v2vnet", "lidar/seg/v2xvit",
           "camera/det/where2comm", "camera/det/lss")


def config(key):
    group, task, name = key.split("/")
    path = os.path.join(cs.REPO, "hypes_yaml/airv2x", group, task, f"{name}.yaml")
    return cs.camera_hypes(path) if group == "camera" else cs.cut_hypes(path)


def trainer(hypes, model, dtype, lr_scale=1.0, eps=None, from_step=0):
    """(state, step) of the YAML's optimizer over ``model``; ``lr_scale``
    multiplies the schedule from update ``from_step`` on."""
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.parallel.train import (
        TrainState, make_optimizer, make_train_step)

    hypes = copy.deepcopy(hypes)
    if eps is not None:
        hypes["optimizer"].setdefault("args", {})["eps"] = eps
    opt, sched = make_optimizer(
        hypes, [p for p in model.parameters() if p.requires_grad], 50)

    def scaled(s):
        return sched(s) * (lr_scale if s >= from_step else 1.0)

    step = make_train_step(build_loss(hypes), scaled, compute_dtype=dtype, seed=0)
    return TrainState(model, opt), step


def keep(model):
    return ({"comm_u": torch.full((cs.TRAIN_BATCH,), cs.REPEAT_KEEP)}
            if getattr(model, "DRAWS_KEEP_FRACTION", False) else {})


def run(state, step, batches, n_prefix=PREFIX):
    """``n_prefix`` steps over ``batches``, then batch 0 REPEATS times."""
    prefix = [float(step(state, batches[i % len(batches)])["total_loss"])
              for i in range(n_prefix)]
    return prefix, repeat(state, step, batches[0])


def repeat(state, step, batch):
    kw = keep(state.model)
    out = []
    for _ in range(REPEATS):
        parts = step(state, batch, **kw)
        out.append({k: float(v) for k, v in parts.items()})
    return out


def verdicts(rep):
    total = [p["total_loss"] for p in rep]
    second = float(np.median(total[len(total) // 2:]))
    return {"loss_fell": bool(cs.loss_fell(total)), "first": total[0],
            "least_of_first_3": min(total[:3]), "second_half_median": second}


def emit(kind, **kw):
    print(json.dumps({"probe": kind, **kw}), flush=True)


def fresh(hypes):
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    return init_flax_like_(build_model(hypes, device="cuda", train=True), seed=0)


def module_groups(model):
    groups = {n: m for n, m in model.named_children()
              if any(True for _ in m.parameters())}
    fusion = getattr(model, "fusion_net", None)
    if fusion is not None:
        groups.update({f"fusion_net.{n}": m for n, m in fusion.named_children()
                       if any(True for _ in m.parameters())})
    return groups


def grad_check(label, hypes, model, batch):
    """Per module, the loss's fall along the module's negative gradient over
    the first-order prediction."""
    from airv2x_tpu_torch.loss import build_loss

    loss_fn = build_loss(hypes)
    cs.set_tf32(False)
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    model.train()
    kw = keep(model)
    if kw:
        kw["generator"] = torch.Generator().manual_seed(0)

    def total(grad=False):
        if kw:
            kw["generator"] = torch.Generator().manual_seed(0)
        with torch.set_grad_enabled(grad):
            t, _ = loss_fn(model(batch, **kw), batch["labels"])
        return t

    try:
        model.zero_grad(set_to_none=True)
        t = total(grad=True)
        t.backward()
        l0 = float(t.detach())
        again = [float(total()) for _ in range(2)]
        rows = {}
        for name, mod in module_groups(model).items():
            ps = [p for p in mod.parameters() if p.grad is not None]
            n2 = float(sum((p.grad.double() ** 2).sum() for p in ps))
            if not ps or n2 == 0.0:
                rows[name] = {"grad_norm": 0.0}
                continue
            saved = [p.detach().clone() for p in ps]
            ratios = []
            for frac in FRACS:
                lr = frac * l0 / n2
                with torch.no_grad():
                    for p in ps:
                        p.sub_(lr * p.grad)
                l1 = float(total())
                with torch.no_grad():
                    for p, s in zip(ps, saved):
                        p.copy_(s)
                ratios.append((l0 - l1) / (frac * l0))
            rows[name] = {"grad_norm": n2 ** 0.5, "params": sum(p.numel() for p in ps),
                          "fall_over_prediction": ratios}
        model.zero_grad(set_to_none=True)
        emit("grad", config=label, loss=l0, loss_again=again, fracs=list(FRACS),
             modules=rows)
    finally:
        cudnn.benchmark, cudnn.deterministic = flags


def handshake(label, model, batch):
    """When2com's scores of the present agents in a train-mode forward."""
    fusion, got = model.fusion_net, {}
    hooks = [fusion.key_net.register_forward_hook(
                 lambda m, a, out: got.__setitem__("keys", out)),
             fusion.query_proj.register_forward_hook(
                 lambda m, a, out: got.__setitem__("query", out))]
    try:
        model.train()
        with torch.no_grad():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    b = got["query"].shape[0]
    keys = got["keys"].float().reshape(b, -1, got["query"].shape[-1])
    scores = torch.einsum("blk,bk->bl", keys, got["query"].float())
    mask = batch["agent_mask"][:, :scores.shape[1]]
    rows = [scores[i][mask[i]].tolist() for i in range(b)]
    attn = [torch.softmax(scores[i][mask[i]], -1).tolist() for i in range(b)]
    emit("handshake", config=label, scores=rows, softmax=attn)


def probe(key):
    t0 = time.perf_counter()
    hypes, model, batches = cs.train_setup(config(key), 2)
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False
    bf16 = torch.bfloat16
    when2com = key == "lidar/det/when2com"
    if when2com:
        handshake(f"{key} initial", model, batches[0])
        grad_check(f"{key} initial", hypes, model, batches[0])
    state, step = trainer(hypes, model, bf16)
    prefix = [float(step(state, batches[i % 2])["total_loss"]) for i in range(PREFIX)]
    model_sd = {k: v.clone() for k, v in model.state_dict().items()}
    opt_sd = copy.deepcopy(state.optimizer.state_dict())
    branches = {}
    for name, scale in (("recipe lr", 1.0), ("lr / 10", cs.REPEAT_LR_SCALE)):
        model.load_state_dict(model_sd)
        st, stp = trainer(hypes, model, bf16, lr_scale=scale, from_step=PREFIX)
        st.optimizer.load_state_dict(opt_sd)
        st.step = PREFIX
        rep = repeat(st, stp, batches[0])
        branches[name] = {"repeats": [p["total_loss"] for p in rep],
                          "last_parts": rep[-1], **verdicts(rep)}
    emit("curve", config=key, variant="bf16, recipe for the prefix", prefix=prefix,
         branches=branches)
    if when2com:
        model.load_state_dict(model_sd)
        handshake(f"{key} after the prefix", model, batches[0])
        grad_check(f"{key} after the prefix", hypes, model, batches[0])
        del model
        variants = (("f32, recipe", dict(dtype=torch.float32)),
                    ("bf16, lr / 10 throughout", dict(dtype=bf16, lr_scale=0.1)),
                    ("bf16, Adam eps 1e-6", dict(dtype=bf16, eps=1e-6)),
                    ("bf16, key and query MLPs frozen", dict(dtype=bf16, freeze=True)))
        for name, v in variants:
            torch.cuda.empty_cache()
            m = fresh(hypes)
            if v.pop("freeze", False):
                for mod in (m.fusion_net.key_net, m.fusion_net.query_net):
                    mod.requires_grad_(False)
            cs.set_tf32(False)
            st, stp = trainer(hypes, m, v.pop("dtype"), **v)
            pre, rep = run(st, stp, batches)
            emit("curve", config=key, variant=name, prefix=pre,
                 branches={"whole run": {"repeats": [p["total_loss"] for p in rep],
                                         "last_parts": rep[-1], **verdicts(rep)}})
            del m, st
    print(f"{key}: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()


def main(argv):
    if not torch.cuda.is_available():
        print("train_card_probes: no CUDA device is available", file=sys.stderr)
        return 2
    print(cs.smi("name,power.limit"), flush=True)
    for key in argv or CONFIGS:
        probe(key)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
