"""The port's training path against the JAX package's, on the CPU in f32:
train-mode norms, the encoder's train path, train-mode communication, both
losses, the schedule and optimizer, whole det / seg train steps (with and
without gradient accumulation), checkpoints and the train CLI; and, after
training, the eval fold cache and the bf16 eval model."""

import math
import os
import shutil

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.fusion.where2comm import Communication as JaxCommunication
from airv2x_tpu.models.nn import MaskedBatchNorm as JaxMaskedBatchNorm
from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu.ops.fast_pillars import FastPillarBEV as JaxFastPillarBEV
from airv2x_tpu.parallel import train as jax_train
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.where2comm import Communication
from airv2x_tpu_torch.models.nn import BatchNorm2d, ConvBNReLU, MaskedBatchNorm
from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_lr_schedule, make_optimizer, make_train_step)
from airv2x_tpu_torch.tools import train as train_cli
from airv2x_tpu_torch.utils.checkpoint import find_last_epoch
from airv2x_tpu_torch.utils.weights import cast_weights_, load_flax_variables
from tests.torch_port_helpers import (
    TINY, assert_close, jnp_tree, nchw_to_nhwc, nhwc_to_nchw, one_torch_thread,
    random_variables, tiny_seg)

LR = 0.002  # the tiny config's base learning rate



# --- train-mode norms -------------------------------------------------------


def test_masked_batchnorm_train_matches_flax():
    """Outputs, the updated running statistics and the gradients of x, scale
    and bias; the masked-out rows (a third) never enter the statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (6, 50, 8)).astype(np.float32)
    mask = rng.uniform(size=(6, 50)) > 0.33
    r = rng.normal(size=x.shape).astype(np.float32)
    var = {"params": {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                      "bias": rng.normal(size=8).astype(np.float32)},
           "batch_stats": {"mean": rng.normal(size=8).astype(np.float32),
                           "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    jm = JaxMaskedBatchNorm()

    def jloss(params, xx):
        y, upd = jm.apply({"params": params, "batch_stats": var["batch_stats"]},
                          xx, jnp.asarray(mask), True, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (y, stats)), (gp, gx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(var["params"], jnp.asarray(x))

    tm = MaskedBatchNorm(8).train()
    load_flax_variables(torch.nn.ModuleDict({"bn": tm}),
                        {"params": {"bn": var["params"]},
                         "batch_stats": {"bn": var["batch_stats"]}})
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tm(tx, torch.from_numpy(mask))
    (ty * torch.from_numpy(r)).sum().backward()
    assert_close(ty.detach().numpy(), np.asarray(y), 1e-5, 1e-5, "y")
    assert_close(tm.running_mean.numpy(), np.asarray(stats["mean"]), 1e-6, 1e-6, "mean")
    assert_close(tm.running_var.numpy(), np.asarray(stats["var"]), 1e-6, 1e-6, "var")
    assert_close(tx.grad.numpy(), np.asarray(gx), 1e-5, 1e-5, "dx")
    assert_close(tm.weight.grad.numpy(), np.asarray(gp["scale"]), 1e-4, 1e-5, "dscale")
    assert_close(tm.bias.grad.numpy(), np.asarray(gp["bias"]), 1e-4, 1e-5, "dbias")


@pytest.mark.parametrize("offset", [0.0, 3.0])
def test_batchnorm2d_train_matches_flax(offset):
    """The BatchNorm2d subclass in train mode against flax's BatchNorm
    (momentum 0.99, eps 1e-3, the biased E[x^2] - E[x]^2 variance): outputs,
    running statistics after two updates, gradients. ``offset`` puts the
    mean away from 0, where the fast variance starts to round apart with
    the order of the sums."""
    rng = np.random.default_rng(1)
    xs = [(rng.normal(offset, 2.0, (3, 7, 9, 5))).astype(np.float32)
          for _ in range(2)]  # NHWC
    r = rng.normal(size=xs[0].shape).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
              "bias": rng.normal(size=5).astype(np.float32)}
    stats = {"mean": rng.normal(size=5).astype(np.float32),
             "var": rng.uniform(0.5, 2, 5).astype(np.float32)}
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3)
    bn = BatchNorm2d(5).train()
    load_flax_variables(torch.nn.ModuleDict({"bn": bn}),
                        {"params": {"bn": params}, "batch_stats": {"bn": stats}})
    for x in xs:
        def jloss(p, xx, st=stats):
            y, upd = jbn.apply({"params": p, "batch_stats": st}, xx,
                               mutable=["batch_stats"])
            return jnp.sum(y * r), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
        bn.zero_grad()
        tx = nhwc_to_nchw(x).requires_grad_(True)
        ty = bn(tx)
        (ty * nhwc_to_nchw(r)).sum().backward()
        assert_close(nchw_to_nhwc(ty), np.asarray(y), 2e-5, 2e-5, "y")
        assert_close(nchw_to_nhwc(tx.grad), np.asarray(gx), 1e-4, 1e-4, "dx")
        assert_close(bn.weight.grad.numpy(), np.asarray(gp["scale"]), 1e-3, 1e-5,
                     "dscale")
        assert_close(bn.bias.grad.numpy(), np.asarray(gp["bias"]), 1e-3, 1e-5,
                     "dbias")
    assert_close(bn.running_mean.numpy(), np.asarray(stats["mean"]), 1e-5, 1e-6, "mean")
    assert_close(bn.running_var.numpy(), np.asarray(stats["var"]), 1e-5, 1e-6, "var")
    # eval mode is nn.BatchNorm2d's own, on the running statistics
    bn.eval()
    with torch.no_grad():
        want = jbn.clone(use_running_average=True).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(xs[0]))
        assert_close(nchw_to_nhwc(bn(nhwc_to_nchw(xs[0]))), np.asarray(want),
                     2e-5, 2e-5, "eval")


# --- the encoder's train path -----------------------------------------------

def test_fast_pillar_train_path_matches_jax():
    """Output grid, BN statistics and the gradients of the dense kernel, the
    BN scale / bias and the points, with a crafted scatter-max tie: a point
    repeated in its cell (the tied maxima share the gradient evenly in both
    packages) and points out of range or masked."""
    hypes = jax_load_yaml(TINY)
    vcfg = hypes["model"]["args"]["rsu"]["lidar"]
    kw = dict(num_filters=[16], voxel_size=[0.4, 0.4, 4],
              lidar_range=hypes["preprocess"]["cav_lidar_range"],
              offset_voxel_size=vcfg["voxel_size"],
              offset_lidar_range=vcfg["lidar_range"])
    rng = np.random.default_rng(2)
    m, n = 3, 400
    pts = np.zeros((m, n, 4), np.float32)
    pts[..., 0] = rng.uniform(-6, 6, (m, n))
    pts[..., 1] = rng.uniform(-6, 6, (m, n))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (m, n))
    pts[..., 3] = rng.uniform(0, 1, (m, n))
    pts[:, 1] = pts[:, 0]  # the tie: a point twice in its cell
    pts[0, 5, 0] = 40.0  # out of range
    mask = rng.uniform(size=(m, n)) > 0.1
    mask[:, :2] = True
    r = rng.normal(size=(m, 96, 96, 16)).astype(np.float32)

    jmod = JaxFastPillarBEV(**kw)
    var = random_variables(jmod, jnp.asarray(pts), jnp.asarray(mask), seed=3,
                           train=False)

    def jloss(params, p):
        g, upd = jmod.apply({"params": params, "batch_stats": var["batch_stats"]},
                            p, jnp.asarray(mask), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(g * r), (g, upd["batch_stats"])

    (_, (grid, stats)), (gp, gpts) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(var["params"], jnp.asarray(pts))

    tmod = FastPillarBEV(**kw).train()
    load_flax_variables(tmod, var)
    tp = torch.from_numpy(pts).requires_grad_(True)
    tg = tmod(tp, torch.from_numpy(mask))
    (tg * torch.from_numpy(r)).sum().backward()
    assert_close(tg.detach().numpy(), np.asarray(grid), 1e-5, 1e-5, "grid")
    assert_close(tmod.bn.running_mean.numpy(),
                 np.asarray(stats["MaskedBatchNorm_0"]["mean"]), 1e-6, 1e-5, "mean")
    assert_close(tmod.bn.running_var.numpy(),
                 np.asarray(stats["MaskedBatchNorm_0"]["var"]), 1e-6, 1e-5, "var")
    assert_close(tmod.dense.weight.grad.numpy().T,
                 np.asarray(gp["Dense_0"]["kernel"]), 1e-3, 1e-4, "dkernel")
    for k, t in (("scale", tmod.bn.weight), ("bias", tmod.bn.bias)):
        assert_close(t.grad.numpy(), np.asarray(gp["MaskedBatchNorm_0"][k]),
                     1e-3, 1e-4, k)
    gpts = np.asarray(gpts)
    assert_close(tp.grad.numpy(), gpts, 1e-4, 1e-4, "dpoints")
    # the tied pair shares its gradient: equal halves, not all on one point
    np.testing.assert_allclose(tp.grad.numpy()[:, 0], tp.grad.numpy()[:, 1],
                               rtol=1e-6, atol=1e-7)
    assert np.abs(gpts[:, 0]).max() > 0


# --- train-mode communication -----------------------------------------------

def test_train_communication_matches_jax():
    """Masks and rates with the keep fraction u injected from the JAX draw.
    Agents 2 and 3 have constant logits: their 48 interior confidences tie
    exactly in each package, and the key's u (0.11 / 0.30 / 0.33 of 120
    pixels) keeps fewer than 48, so the stable ranks must pick the ties by
    pixel index. (Border pixels that tie only in exact arithmetic round
    apart by an ulp in one package or the other, so k stays inside the
    interior group.)"""
    rng = np.random.default_rng(4)
    b, l, h, w, ac = 3, 4, 12, 10, 6
    psm = rng.normal(0, 2, (b, l, h, w, ac)).astype(np.float32)
    psm[:, 2:] = 0.7
    agent_mask = np.array([[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 0, 0]], bool)
    key = jax.random.PRNGKey(57)
    u = np.asarray(jax.random.uniform(key, (b,)))
    want_mask, want_rate = JaxCommunication().apply(
        {}, jnp.asarray(psm), jnp.asarray(agent_mask), train=True, rng=key)
    comm = Communication().train()
    got_mask, got_rate = comm(torch.from_numpy(psm).permute(0, 1, 4, 2, 3),
                              torch.from_numpy(agent_mask),
                              comm_u=torch.from_numpy(u))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert float(got_rate) == pytest.approx(float(want_rate), abs=1e-7)
    assert 0 < float(got_rate) < 1
    # u from a CPU generator when not injected, and the same draw twice
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    x = torch.from_numpy(psm).permute(0, 1, 4, 2, 3)
    a = comm(x, torch.from_numpy(agent_mask), generator=g1)[0]
    assert torch.equal(a, comm(x, torch.from_numpy(agent_mask), generator=g2)[0])
    with pytest.raises(ValueError):
        comm(x, torch.from_numpy(agent_mask))


# --- losses ------------------------------------------------------------------

@pytest.fixture(scope="module")
def labelled():
    """Two tiny det batches with their labels (seg labels too), from JAX."""
    hypes = jax_load_yaml(TINY)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    batch, _ = jax_make_batch(
        np.random.default_rng(3), JaxSlotLayout.from_args(hypes["model"]["args"]),
        2, anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=hypes["postprocess"]["target_args"], seg_hw=96,
        num_objects=4, points_per_agent=512,
        lidar_range=hypes["preprocess"]["cav_lidar_range"],
        max_boxes=hypes["postprocess"]["max_num"], pts_per_box=40)
    return batch


@pytest.mark.parametrize("task", ["det", "seg"])
def test_losses_match_jax(labelled, task):
    """The loss parts and their gradients on random logits: the det loss's
    double 1/B, log(sigmoid + 1e-6) and smooth-L1 on sin-difference yaw; the
    seg loss's class-weighted CE over the sum of the target weights."""
    hypes = jax_load_yaml(TINY)
    th = load_yaml(TINY)
    if task == "seg":
        tiny_seg(hypes)
        tiny_seg(th)
    rng = np.random.default_rng(6)
    if task == "det":
        out = {"psm": rng.normal(0, 3, (2, 48, 48, 14)),
               "rm": rng.normal(0, 1, (2, 48, 48, 14)),
               "obj": rng.normal(0, 3, (2, 48, 48, 2))}
    else:
        out = {"dynamic_seg": rng.normal(0, 3, (2, 96, 96, 7)),
               "static_seg": rng.normal(0, 3, (2, 96, 96, 3))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out["comm_rate"] = np.float32(0.5)
    labels = labelled["labels"]
    jloss = jax_build_loss(hypes)
    keys = [k for k in out if k != "comm_rate"]

    def jfn(o):
        return jloss({**o, "comm_rate": jnp.asarray(0.5)}, jnp_tree(labels))

    (_, jparts), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(out[k]) for k in keys})
    touts = {k: torch.from_numpy(v).requires_grad_(k != "comm_rate")
             for k, v in ((k, np.asarray(v)) for k, v in out.items())}
    total, parts = build_loss(th)(touts, batch_to_torch(labels, "cpu"))
    total.backward()
    assert set(parts) == set(jparts)
    for k in parts:
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5, abs=1e-6), k
    for k in keys:
        assert_close(touts[k].grad.numpy(), np.asarray(jgrad[k]), 1e-7, 1e-4, k)


# --- schedule and optimizer ---------------------------------------------------

SCHEDULES = {
    "multistep": {"core_method": "multistep", "gamma": 0.1, "step_size": [2, 5]},
    "step": {"core_method": "step", "gamma": 0.5, "step_size": 2},
    "exponential": {"core_method": "exponential", "gamma": 0.9},
    "cosineannealwarm": {"core_method": "cosineannealwarm", "epoches": 6,
                         "warmup_epoches": 1, "warmup_lr": 2e-4, "lr_min": 2e-5},
    "constant": {},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_matches_optax(name):
    """At, just before and just after each boundary (epochs x 7 steps), as
    optax evaluates it at the count of updates already made."""
    hypes = {"optimizer": {"lr": 0.002}, "lr_scheduler": SCHEDULES[name]}
    spe = 7
    want = jax_train.make_lr_schedule(hypes, spe)
    got = make_lr_schedule(hypes, spe)
    for step in sorted({0, 1, 6, 7, 8, 13, 14, 15, 34, 35, 36, 41, 42, 43, 60}):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6), step
    if name == "multistep":
        assert got(13) == pytest.approx(0.002) and got(14) == pytest.approx(2e-4)
        assert got(35) == pytest.approx(2e-5)


def test_adamw_matches_optax():
    """AdamW (eps 1e-10, weight decay 1e-4, every leaf decayed) under the
    multistep schedule against optax.adamw, over 4 updates across a
    boundary; and Adam with no decay."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    grads = [rng.normal(size=(5, 3)).astype(np.float32) for _ in range(4)]
    for wd in (1e-4, 0.0):
        hypes = {"optimizer": {"core_method": "Adam", "lr": 0.002,
                               "args": {"eps": 1e-10, "weight_decay": wd}},
                 "lr_scheduler": {"core_method": "multistep", "gamma": 0.1,
                                  "step_size": [1]}}
        tx, sched = jax_train.make_optimizer(hypes, steps_per_epoch=2)
        jp = jnp.asarray(p0)
        st = tx.init(jp)
        tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        opt, tsched = make_optimizer(hypes, [tp], steps_per_epoch=2)
        for i, g in enumerate(grads):
            upd, st = tx.update(jnp.asarray(g), st, jp)
            jp = optax.apply_updates(jp, upd)
            for group in opt.param_groups:
                group["lr"] = tsched(i)
            tp.grad = torch.from_numpy(g)
            opt.step()
            assert_close(tp.detach().numpy(), np.asarray(jp), 1e-7, 1e-6, f"step {i}")


# --- whole train steps --------------------------------------------------------

def _tiny(task):
    jh, th = jax_load_yaml(TINY), load_yaml(TINY)
    if task == "seg":
        tiny_seg(jh)
        tiny_seg(th)
    return jh, th


def _comm_cut_gaps(th, variables, batch):
    """Per sample and per k, the smallest relative gap over the present
    agents between the k-th and (k+1)-th largest train-mode confidence of
    the port (f32, the initial weights): where it is tiny, rounding decides
    which pixels the top-k keep takes."""
    from airv2x_tpu_torch.models.fusion.where2comm import gaussian_smooth

    model = build_model(th, device="cpu", train=True)
    load_flax_variables(model, variables)
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        psm = model.single_psm(model.encode(tb)).double()
    b = tb["agent_mask"].shape[0]
    conf = gaussian_smooth(torch.sigmoid(psm).amax(1), 5, 1.0)
    conf = conf.reshape(b, -1, conf.shape[-2] * conf.shape[-1])
    srt = conf.sort(-1, descending=True)[0]
    gap = (srt[..., :-1] - srt[..., 1:]) / srt[..., :-1].abs().clamp_min(1e-30)
    gap = torch.where(tb["agent_mask"][..., None], gap, torch.inf)
    return gap.amin(1).numpy()  # (B, H*W - 1): k -> the gap below rank k


def _microbatches(batch, accum):
    return [jax.tree.map(lambda a, i=i: a[i * 2 // accum:(i + 1) * 2 // accum], batch)
            for i in range(accum)]


def _clean_keep_fraction(th, variables, batch, accum, target):
    """A keep fraction near ``target`` whose cut k = floor(u * H * W) lies,
    in every present agent of every sample of every microbatch, on a
    relative confidence gap of at least 1e-5: 40x the port's f32-against-f64
    rounding of the confidences (2.4e-7 on this config), so no package's
    rounding moves a pixel across the cut. Tied confidences are common
    (empty BEV cells), and rounding orders the ties of exact arithmetic."""
    gaps = np.concatenate([_comm_cut_gaps(th, variables, mb)
                           for mb in _microbatches(batch, accum)]).min(0)
    hw = gaps.shape[0] + 1
    ks = np.nonzero(gaps > 1e-5)[0] + 1
    k = ks[np.argmin(np.abs(ks - target * hw))]
    return np.float32((k + 0.5) / hw)


def _inject_keep_fraction(mp, u, dtype=jnp.float32):
    """Make the JAX package's communication draw ``u`` for every sample (it
    is the only caller of ``jax.random.uniform`` on these models)."""
    mp.setattr(jax.random, "uniform",
               lambda key, shape, *a, **k: jnp.full(shape, u, dtype))


def _jax_step(hypes, batch, variables, accum, u):
    """One JAX ``make_train_step`` update (jitted, adamw + multistep) with
    the keep fraction ``u`` injected, and the gradients it applied (recorded
    through a debug callback in the optimizer's update)."""
    tx, _ = jax_train.make_optimizer(hypes, 50)
    grads = []

    def update(g, s, p=None):
        jax.debug.callback(lambda gg: grads.append(jax.tree.map(np.asarray, gg)), g)
        return tx.update(g, s, p)

    rec_tx = optax.GradientTransformation(tx.init, update)
    model = jax_build_model(hypes)
    state = jax_train.create_train_state(model, variables, rec_tx)
    step = jax_train.make_train_step(model, jax_build_loss(hypes), rec_tx,
                                     donate=False, accum_steps=accum)
    with pytest.MonkeyPatch.context() as mp:
        _inject_keep_fraction(mp, u)
        new_state, parts = step(state, jax.tree.map(jnp.asarray, batch),
                                jax.random.PRNGKey(7))
        jax.effects_barrier()
    (g,) = grads
    return (jax.tree.map(np.asarray, new_state.params),
            jax.tree.map(np.asarray, new_state.batch_stats),
            {k: float(v) for k, v in parts.items()}, g)


@pytest.fixture(scope="module", params=[("det", 1), ("seg", 1), ("det", 2)],
                ids=["det", "seg", "det-accum2"])
def step_run(request, labelled):
    task, accum = request.param
    jh, th = _tiny(task)
    batch = labelled
    scene = {k: v for k, v in batch.items() if k != "labels"}
    variables = random_variables(jax_build_model(jh), jnp_tree(scene), seed=5,
                                 train=False)
    u = _clean_keep_fraction(th, variables, batch, accum, 0.6)
    params, stats, jparts, jgrads = _jax_step(jh, batch, variables, accum, u)

    model = build_model(th, device="cpu", train=True)
    load_flax_variables(model, variables)
    opt, sched = make_optimizer(th, model.parameters(), 50)
    state = TrainState(model, opt)
    step = make_train_step(build_loss(th), sched, accum_steps=accum)
    tparts = step(state, batch_to_torch(batch, "cpu"),
                  comm_u=torch.full((2,), float(u)))
    assert state.step == 1

    def twin(p, s):
        t = build_model(th, device="cpu")
        load_flax_variables(t, {"params": p, "batch_stats": s})
        return t

    return dict(model=model, parts=tparts, jparts=jparts,
                grads=twin(jgrads, stats), after=twin(params, stats))


# Tolerances of a whole f32 step. The gradients go back through ~20
# train-mode BNs and the ego attention. Measured on this config, the JAX
# package's own f32 gradients on the CPU lie up to 3.3e-2 of a leaf's scale
# (its largest |g|) from the same JAX graph in float64 (the seg rsu
# encoder's kernel, a leaf whose gradients are 1e-2 of the step's largest),
# while the port's f32 lie within 1.1e-5 of it; in float64 the two packages
# agree to 3.7e-6 (test_train_step_gradients_match_jax_f64). So the f32
# comparison is bounded by JAX's rounding: 2e-2 of each leaf's scale plus
# 5e-4 of the step's largest gradient.
STEP_GRAD_TOL = 2e-2
STEP_GRAD_FLOOR = 5e-4
STEP_LOSS_TOL = 1e-5  # relative
# both packages in float64 (with the same f32 islands): measured 3.7e-6
F64_GRAD_TOL = 5e-5


def test_train_step_loss_parts_match_jax(step_run):
    got, want = step_run["parts"], step_run["jparts"]
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(want[k], rel=STEP_LOSS_TOL, abs=1e-6), k
    assert math.isfinite(want["total_loss"]) and want["total_loss"] > 0


def test_train_step_gradients_match_jax(step_run):
    """Every gradient leaf, mapped into a twin model by the weight bridge
    (linear per leaf, so it carries gradients as it carries weights), within
    STEP_GRAD_TOL of the leaf's scale plus STEP_GRAD_FLOOR of the largest
    gradient of the step (JAX's f32 rounding of the small leaves)."""
    want = dict(step_run["grads"].named_parameters())
    top = max(np.abs(w.detach().numpy()).max() for w in want.values())
    for name, p in step_run["model"].named_parameters():
        g, w = p.grad.numpy(), want[name].detach().numpy()
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= STEP_GRAD_TOL * scale + STEP_GRAD_FLOOR * top, (name, err, scale)


def test_train_step_params_and_bn_stats_match_jax(step_run):
    """Updated parameters: the first Adam step moves each entry by about
    +-lr, so entries whose JAX gradient clears the gradient tolerance must
    agree to 1e-6; the rest (noise-level gradients, whose sign either
    package may flip) within 2 lr. BN running statistics to 1e-5."""
    want = dict(step_run["after"].named_parameters())
    grads = dict(step_run["grads"].named_parameters())
    clear = 0
    for name, p in step_run["model"].named_parameters():
        got, w = p.detach().numpy(), want[name].detach().numpy()
        g = grads[name].detach().numpy()
        sure = np.abs(g) > 2 * STEP_GRAD_TOL * np.abs(g).max()
        clear += int(sure.sum())
        err = np.abs(got - w)
        assert err[sure].max(initial=0) <= 1e-6 * (1 + np.abs(w[sure]).max(initial=0)), name
        assert err.max() <= 2 * LR + 1e-6, name
    assert clear > 1000
    bufs = dict(step_run["after"].named_buffers())
    for name, b in step_run["model"].named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        assert_close(b.numpy(), bufs[name].numpy(), 1e-5, 1e-5, name)


@pytest.mark.parametrize("task", ["det", "seg"])
def test_train_step_gradients_match_jax_f64(task, labelled):
    """The same gradients with both packages in float64 (the JAX model built
    with a float64 module dtype under ``jax.enable_x64``; in both, the
    masked-BN statistics and the cell sums stay f32, as the JAX package
    casts them), the same variables, batch and injected keep fraction: the
    two compute one function, to F64_GRAD_TOL of each leaf's scale. In f64
    the near-tied maxima of the encoder's scatter-max and the near-tied
    confidences of the top-k keep are ordered alike, which f32 rounding
    does not promise."""
    from airv2x_tpu.models.where2comm_model import Airv2xWhere2comm

    jh, th = _tiny(task)
    scene = {k: v for k, v in labelled.items() if k != "labels"}
    variables = random_variables(jax_build_model(jh), jnp_tree(scene), seed=5,
                                 train=False)
    args = dict(jh["model"]["args"], preprocess=jh["preprocess"],
                postprocess=jh["postprocess"])
    u = _clean_keep_fraction(th, variables, labelled, 1, 0.37)

    def f64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        _inject_keep_fraction(mp, u, jnp.float64)
        model = Airv2xWhere2comm(args=args, dtype=jnp.float64)
        loss_fn = jax_build_loss(jh)
        v64 = jax.tree.map(lambda a: jnp.asarray(f64(a)), variables)
        b64 = jax.tree.map(lambda a: jnp.asarray(f64(a)), labelled)

        def loss(params):
            out, _ = model.apply({"params": params, "batch_stats": v64["batch_stats"]},
                                 b64, True, rngs={"comm": jax.random.PRNGKey(0)},
                                 mutable=["batch_stats"])
            return loss_fn(out, b64["labels"])[0]

        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v64["params"]))

    tm = build_model(th, device="cpu", train=True).double()
    load_flax_variables(tm, jax.tree.map(f64, variables))
    batch = batch_to_torch(jax.tree.map(f64, labelled), "cpu")
    total, _ = build_loss(th)(tm(batch, comm_u=torch.full((2,), float(u))),
                              batch["labels"])
    total.backward()
    twin = build_model(th, device="cpu").double()
    load_flax_variables(twin, {"params": grads,
                               "batch_stats": jax.tree.map(f64, variables["batch_stats"])})
    want = dict(twin.named_parameters())
    for name, p in tm.named_parameters():
        g, w = p.grad.numpy(), want[name].detach().numpy()
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= F64_GRAD_TOL * scale, (
            name, np.abs(g - w).max(), scale)


# --- checkpoints, CLI, eval after training -------------------------------------

def _cli(tmp_path, *extra):
    return train_cli.main(["--hypes_yaml", TINY, "--device", "cpu",
                           "--log_dir", str(tmp_path / "logs"),
                           "--steps_per_epoch", "2", *extra])


@pytest.fixture(scope="module")
def one_epoch_run(tmp_path_factory):
    """One epoch of the CLI, shared by the two tests that need it."""
    return _cli(tmp_path_factory.mktemp("one_epoch"), "--epochs", "1")


def test_cli_one_epoch(one_epoch_run):
    run_dir = one_epoch_run
    assert find_last_epoch(run_dir) == 1
    with open(os.path.join(run_dir, "train_loss.txt")) as f:
        line = f.read()
    assert line.startswith("epoch 1/1") and "total_loss" in line
    with open(os.path.join(run_dir, "validation_loss.txt")) as f:
        assert f.read().startswith("epoch: 1, loss:")  # eval_freq 1
    with open(os.path.join(run_dir, "config.yaml")) as f:
        assert yaml.safe_load(f)["name"] == "tiny_where2comm"


def test_checkpoint_resume_equals_uninterrupted_run(tmp_path, one_epoch_run):
    """Two epochs in one run against one epoch, then a resume from its
    checkpoint (model, AdamW moments, step count): the same weights. The
    resume runs in a copy of the shared one-epoch run dir."""
    whole = _cli(tmp_path / "a", "--epochs", "2")
    part = str(shutil.copytree(one_epoch_run, tmp_path / "b"))
    _cli(tmp_path / "b", "--epochs", "2", "--model_dir", part)
    a = torch.load(os.path.join(whole, "net_epoch2"), weights_only=True)
    b = torch.load(os.path.join(part, "net_epoch2"), weights_only=True)
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        torch.testing.assert_close(b["model"][k], a["model"][k], rtol=0, atol=0)
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    for i in sa:
        torch.testing.assert_close(sb[i]["exp_avg_sq"], sa[i]["exp_avg_sq"],
                                   rtol=0, atol=0)


def test_cli_refuses_real_root_dir_and_missing_card(tmp_path):
    hypes = load_yaml(TINY)
    root = tmp_path / "dataset"
    root.mkdir()
    hypes["root_dir"] = str(root)
    # a root_dir without samples falls back to synthetic scenes, where a
    # radar-only model the CLI draws no radar cloud for is refused before
    # the CLI builds a loader or a run dir
    hypes["model"]["core_method"] = "point_pillar_spatialcooper"
    hypes["model"]["args"]["use_modality"] = "processed_radar"
    cfg = tmp_path / "cfg.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump(jax.tree.map(lambda v: v.tolist() if hasattr(v, "tolist")
                                    else v, hypes), f)
    with pytest.raises(NotImplementedError, match="processed_radar"):
        train_cli.main(["--hypes_yaml", str(cfg), "--device", "cpu",
                        "--log_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            train_cli.main(["--hypes_yaml", TINY, "--log_dir",
                            str(tmp_path / "logs")])
    assert train_cli.resolve_grad_accum(0, 4) == 2
    assert train_cli.resolve_grad_accum(0, 2) == 1
    assert train_cli.resolve_grad_accum(3, 6) == 3


@pytest.mark.parametrize("impl", ["foreach", "fused", "single"])
def test_fold_cache_sees_every_adamw_update(impl, monkeypatch):
    """``ConvBNReLU._fold`` keys its cache on (data_ptr, _version) of the
    conv weight and the four BN tensors. A train-mode forward bumps the
    running statistics' versions and AdamW's foreach and single-tensor
    updates bump the parameters'; the fused update does not (on this
    build), so ``train()`` / ``eval()`` drop the cache: in each case the
    eval fold after the update is the updated weights' own."""
    blk = ConvBNReLU(8, 8).eval()
    x = torch.randn(2, 8, 6, 6)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    with torch.no_grad():
        blk(x)  # caches the fold

    def key():
        return [(t.data_ptr(), t._version) for t in (
            blk.conv.weight, blk.bn.weight, blk.bn.bias, blk.bn.running_mean,
            blk.bn.running_var)]

    k0 = key()
    blk.train()
    blk(x).square().sum().backward()
    k1 = key()
    assert k1[3] != k0[3] and k1[4] != k0[4]  # running statistics
    flags = {"foreach": dict(foreach=True), "fused": dict(fused=True),
             "single": dict(foreach=False)}[impl]
    torch.optim.AdamW(blk.parameters(), lr=1e-3, weight_decay=1e-4, **flags).step()
    bumped = all(a != b for a, b in zip(k1[:3], key()[:3]))
    assert bumped == (impl != "fused")
    blk.eval()
    with torch.no_grad():
        got = blk(x)
        monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
        want = blk(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("task", ["det", "seg"])
def test_pallas_eval_after_training_matches_auto(task, monkeypatch, labelled):
    """Two train steps with fused AdamW, then eval: the ``pallas`` conv path
    (K4's plain version on the CPU, whose fold was cached before the steps)
    equals ``auto`` on the trained weights, so no stale fold survives
    training."""
    _, th = _tiny(task)
    model = build_model(th, device="cpu", train=True)
    batch = batch_to_torch(labelled, "cpu")
    scene = {k: v for k, v in batch.items() if k != "labels"}
    model.eval()
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    with torch.no_grad():
        model(scene)  # caches every fold of the initial weights
    _, sched = make_optimizer(th, model.parameters(), 50)
    # fused: the AdamW update that does not bump the weights' versions
    opt = torch.optim.AdamW(model.parameters(), eps=1e-10, weight_decay=1e-4,
                            fused=True)
    state = TrainState(model, opt)
    step = make_train_step(build_loss(th), sched)
    for _ in range(2):
        step(state, batch, comm_u=torch.tensor([0.3, 0.8]))
    model.eval()
    with torch.no_grad():
        got = model(scene)
        monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
        want = model(scene)
    for k in want:
        assert_close(got[k].numpy(), want[k].numpy(), 1e-4, 1e-4, k)


def test_cast_weights_refuses_a_training_model():
    """The serving cast never rounds the f32 master weights of a model that
    trains (the train step's bf16 is autocast)."""
    model = build_model(load_yaml(TINY), device="cpu", train=True)
    with pytest.raises(ValueError):
        cast_weights_(model, torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    cast_weights_(model.eval(), torch.bfloat16)
    assert model.backbone.stages[0].layers[0].conv.weight.dtype == torch.bfloat16


# --- bf16 eval against JAX bf16 -------------------------------------------------

# measured on this config (seed-21 variables, one make_scene batch): the
# port's bf16 psm / rm / obj lie 0.28 / 0.30 / 0.17 from JAX bf16 under auto
# and 0.31 / 0.36 / 0.22 under pallas at output scales 20.1 / 22.0 / 15.4;
# each side lies 0.22-0.83 from JAX f32; this test's variables (the cls head
# scaled down, see below) read 0.030 / 0.30 / 0.19 and 0.031 / 0.36 / 0.22
# at scales 4.4 / 22.3 / 15.3. The bound: 0.03 x (1 + scale), 0.70 at rm.
BF16_TOL = 0.03


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_bf16_eval_matches_jax_bf16(mode, monkeypatch):
    """The serving model cast to bf16 (``cast_weights_``) against the JAX
    package computing in bf16 with f32 parameters, under ``auto`` and
    ``pallas``; a near-constant single-agent confidence keeps the comm mask
    away from its threshold on both sides."""
    from airv2x_tpu.data.synthetic import make_scene as jax_make_scene

    jh = jax_load_yaml(TINY)
    jh["model"]["args"]["dtype"] = "bf16"
    jmodel = jax_build_model(jh)
    rng = np.random.default_rng(0)
    b, _ = jax_make_scene(rng, JaxSlotLayout.from_args(jh["model"]["args"]),
                          num_objects=6, points_per_agent=1024, pts_per_box=60,
                          lidar_range=jh["preprocess"]["cav_lidar_range"])
    batch = {k: v[None] for k, v in b.items()}
    var = random_variables(jmodel, jnp_tree(batch), seed=21, train=False)
    cls = var["params"]["heads"]["cls_head"]
    cls["kernel"] = cls["kernel"] * np.float32(1e-3)
    conf = 0.012863  # see tests/test_torch_where2comm.py
    cls["bias"] = np.full_like(cls["bias"], math.log(conf / (1 - conf)))
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    want = jax.jit(lambda v, bb: jmodel.apply(v, bb, train=False))(var, jnp_tree(batch))
    tmodel = build_model(load_yaml(TINY), device="cpu")
    load_flax_variables(tmodel, var)
    cast_weights_(tmodel, torch.bfloat16)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        g, w = got[k].float().numpy(), np.asarray(want[k], np.float32)
        scale = np.abs(w).max()
        assert scale > 1
        assert np.abs(g - w).max() <= BF16_TOL * (1 + scale), (k, np.abs(g - w).max(), scale)
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]), abs=1e-6)
