"""Shared helpers of the train-step parity tests (tests/test_torch_train_*.py):
one JAX ``make_train_step`` update and the port's from the same flax
variables, batch and keep fraction, and the checks that hold the two
together (loss parts, every gradient leaf, the updated parameters and BN
statistics), at the tolerances of the flagship's step tests
(tests/test_torch_train.py, which states how they were measured).

The gradients the JAX step applied are read from its optimizer's state
(``applied_gradients``: a first AdamW update from a zero state leaves
(1 - b1) g as its first moment), so that the jitted step holds no host
callback and XLA's persistent compilation cache can keep it (a program
with a host callback is never cached). ``jit=False`` runs the JAX step eagerly,
``jit="spine"`` eagerly but for the model's spine and the update, and
``compiler_options=XLA_OPT0`` jits it without LLVM's optimisations, which
V2VNet and When2com need: XLA's CPU jit miscompiles their fusions (ROADMAP
§3). In float64
(``dtype=jnp.float64``) both packages compute in double with the JAX
package's f32 islands (the masked-BN statistics, the cell sums, the warp
grids, the losses).
"""

from __future__ import annotations

import contextlib
import functools
import copy
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu.parallel import train as jax_train
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.parallel.train import (
    TrainState, freeze_by_path, make_optimizer, make_train_step,
    trainable_parameters)
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_train import (
    F64_GRAD_TOL, LR, STEP_GRAD_FLOOR, STEP_GRAD_TOL, STEP_LOSS_TOL,
    _inject_keep_fraction)
from tests.torch_port_helpers import CHIP_SMOKE, TINY, random_variables

STEPS_PER_EPOCH = 50  # the schedule's length in both packages' optimizers
# XLA's CPU backend without its LLVM optimisations, where the default compile
# miscompiles the V2VNet and When2com fusions: the jitted When2com det step
# then reads the eager step's loss (tests/test_torch_train_eager.py)
XLA_OPT0 = {"xla_backend_optimization_level": 0}


def f64(a):
    """A float32 array as float64; other arrays as they are."""
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def jax_model(hypes, dtype=jnp.float32):
    """The JAX package's model of ``hypes`` in ``dtype`` (``build_model``
    reads only f32 / bf16 from the config)."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    args.setdefault("postprocess", hypes.get("postprocess"))
    return JAX_REGISTRY[hypes["model"]["core_method"]](args=args, dtype=dtype)


# the submodules that ``jax_step(jit="spine")`` jits: the point encoder, the
# BEV backbone and its shrink / compression convs, the heads, and within
# When2com's fusion its policy CNN and key / query nets (not its warp)
SPINE = ("encoder", "backbone", "shrink_conv", "compressor", "heads",
         "seg_head", "fusion_net/PolicyNet_0", "fusion_net/key_net",
         "fusion_net/query_net")


@contextlib.contextmanager
def jit_submodules(paths):
    """Within the block, every flax submodule whose scope path (names
    joined by "/", from the root model) is in ``paths`` runs as one jitted
    call (its variables in, its mutated collections written back);
    everything else runs as it would. In an eager step this compiles each
    such submodule once instead of each of its primitives."""
    cache, inside = {}, []

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if (inside or context.method_name != "__call__"
                or "/".join(mod.path) not in paths):
            return next_fun(*args, **kwargs)
        unbound, variables = mod.unbind()
        mutable = tuple(c for c in variables if mod.is_mutable_collection(c))
        leaves, treedef = jax.tree.flatten((args, kwargs))
        dyn = tuple(isinstance(a, (jax.Array, np.ndarray)) for a in leaves)
        static = tuple(a for a, d in zip(leaves, dyn) if not d)
        key = (type(mod), mod.path, treedef, static, dyn, mutable)
        if key not in cache:
            def call(v, arrays, unbound=unbound):
                it, st = iter(arrays), iter(static)
                a, kw = jax.tree.unflatten(
                    treedef, [next(it) if d else next(st) for d in dyn])
                if not mutable:
                    return unbound.apply(v, *a, **kw), {}
                return unbound.apply(v, *a, **kw, mutable=list(mutable))
            cache[key] = jax.jit(call)
        inside.append(mod.path)
        try:
            out, updated = cache[key](
                dict(variables), [a for a, d in zip(leaves, dyn) if d])
        finally:
            inside.pop()
        for col, tree in updated.items():
            for name, value in tree.items():
                mod.put_variable(col, name, value)
        return out

    with nn.intercept_methods(interceptor):
        yield


_XLA_CONV = jax.lax.conv_general_dilated
_NHWC = ("NHWC", "HWIO", "NHWC")


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _conv_taps(x, w, strides, padding, depthwise, precision):
    """NHWC x HWIO, jitted: an eager float64 ``jnp.pad`` of jax 0.9.0 on
    the CPU returned wrong values in repeated calls (ROADMAP §3)."""
    kh, kw, _, _ = w.shape
    x = jnp.pad(x, ((0, 0), *padding, (0, 0)))
    sh, sw = strides
    oh, ow = (x.shape[1] - kh) // sh + 1, (x.shape[2] - kw) // sw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            tap = x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            y = (tap * w[i, j, 0] if depthwise else jax.lax.dot_general(
                tap, w[i, j], (((3,), (0,)), ((), ())), precision=precision))
            out = y if out is None else out + y
    return out


def conv_by_taps(lhs, rhs, window_strides, padding, lhs_dilation=None,
                 rhs_dilation=None, dimension_numbers=None, feature_group_count=1,
                 batch_group_count=1, precision=None, preferred_element_type=None,
                 **kw):
    """``jax.lax.conv_general_dilated`` for a float64 2-D NHWC convolution
    (undilated; dense or depthwise) as a sum over the kernel's taps of
    strided slices times the tap's weights (a matmul; depthwise, a
    product); any other convolution goes to ``lax.conv_general_dilated``.
    The same sums in another order (float64 rounding apart, ~1e-15 of
    the scale), at a fraction of the time: XLA's CPU convolution in
    float64 took 110 of the When2com float64 step's 155 s on an 8-core x86
    host (its policy net's 3x3 convs at 64 -> 512 channels, forward and
    gradient)."""
    call = dict(lhs_dilation=lhs_dilation, rhs_dilation=rhs_dilation,
                dimension_numbers=dimension_numbers,
                feature_group_count=feature_group_count,
                batch_group_count=batch_group_count, precision=precision,
                preferred_element_type=preferred_element_type, **kw)
    if (lhs.ndim != 4 or lhs.dtype != jnp.float64 or rhs.dtype != jnp.float64
            or kw or preferred_element_type is not None or batch_group_count != 1
            or any(d != 1 for d in (lhs_dilation or ()) + (rhs_dilation or ()))
            or jax.lax.conv_dimension_numbers(lhs.shape, rhs.shape, dimension_numbers)
            != jax.lax.conv_dimension_numbers(lhs.shape, rhs.shape, _NHWC)):
        return _XLA_CONV(lhs, rhs, window_strides, padding, **call)
    kh, kw_, cg, cout = rhs.shape
    depthwise = feature_group_count == lhs.shape[-1] == cout and cg == 1
    if isinstance(padding, str):
        padding = jax.lax.padtype_to_pads(lhs.shape[1:3], (kh, kw_),
                                          window_strides, padding)
    padding = tuple(tuple(int(p) for p in pair) for pair in padding)
    if (not (feature_group_count == 1 or depthwise)
            or min(p for pair in padding for p in pair) < 0):
        return _XLA_CONV(lhs, rhs, window_strides, padding, **call)
    return _conv_taps(lhs, rhs, tuple(window_strides), padding, depthwise, precision)


@contextlib.contextmanager
def f64_convs_by_taps():
    """Within the block, ``jax.lax.conv_general_dilated`` is
    ``conv_by_taps``: the JAX package's float64 2-D convolutions run as sums
    of matmuls over the kernel's taps, every other convolution as before."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "conv_general_dilated", conv_by_taps)
        yield


def jax_step(hypes, batch, variables, *, accum=1, u=None, jit=True,
             dtype=jnp.float32, compiler_options=None):
    """One JAX ``make_train_step`` update (adamw + the config's schedule)
    with the keep fraction ``u`` injected where given; ``compiler_options``
    go to the jitted step's compile. ``jit=False`` runs the step eagerly;
    ``jit="spine"`` runs it eagerly but for the model's SPINE submodules
    and the optimizer's update, each jitted: the warps, the rest of the
    fusion, the model's glue and the loss stay eager (on the V2VNet and
    When2com float64 det steps the loss parts are bit for bit the eager
    step's, every gradient within 1e-12 of it, at a third to half of its
    time: ``python -m tests.train_reference_probes``). In float64 the
    convolutions run as ``conv_by_taps``. Returns (params, batch_stats, loss
    parts, the gradients applied), numpy."""
    x64 = dtype == jnp.float64
    spine = jit == "spine"
    with (jax.enable_x64(x64), pytest.MonkeyPatch.context() as mp,
          jit_submodules(SPINE if spine else ()),
          f64_convs_by_taps() if x64 else contextlib.nullcontext()):
        if u is not None:
            _inject_keep_fraction(mp, u, dtype)
        tx, _ = jax_train.make_optimizer(hypes, STEPS_PER_EPOCH)
        if spine:
            tx = optax.GradientTransformation(tx.init, jax.jit(tx.update))
            mp.setattr(optax, "apply_updates", jax.jit(optax.apply_updates))
        cast = f64 if x64 else np.asarray
        model = jax_model(hypes, dtype)
        var = jax.tree.map(lambda a: jnp.asarray(cast(a)), variables)
        state = jax_train.create_train_state(model, var, tx)
        step = jax_train.make_train_step(model, jax_build_loss(hypes), tx,
                                         donate=False, accum_steps=accum,
                                         jit=jit is True,
                                         compiler_options=compiler_options)
        new_state, parts = step(
            state, jax.tree.map(lambda a: jnp.asarray(cast(a)), batch),
            jax.random.PRNGKey(7))
        return (jax.tree.map(np.asarray, new_state.params),
                jax.tree.map(np.asarray, new_state.batch_stats),
                {k: float(v) for k, v in parts.items()},
                applied_gradients(new_state.opt_state))


ADAM_B1 = 0.9  # optax's adam / adamw default, which the JAX package keeps


def applied_gradients(opt_state):
    """The gradients of a first AdamW update from a zero state, numpy: its
    first moment is (1 - b1) g (optax ``scale_by_adam``), so g is within
    an ulp of mu / (1 - b1)."""
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    (state,) = adam
    assert int(state.count) == 1, "not the first update"
    return jax.tree.map(lambda m: np.asarray(m) / (1 - ADAM_B1), state.mu)


def port_step(hypes, batch, variables, *, accum=1, u=None, double=False,
              freeze=()):
    """The port's update from the same variables: (model after the step,
    loss parts as floats). ``freeze``: flax scope prefixes whose parameters
    ``freeze_by_path`` takes out of the optimizer."""
    model = build_model(hypes, device="cpu", train=True)
    if double:
        model.double()
        variables = jax.tree.map(f64, variables)
        batch = jax.tree.map(f64, batch)
    load_flax_variables(model, variables)
    if freeze:
        freeze_by_path(model, freeze)
    opt, sched = make_optimizer(hypes, trainable_parameters(model),
                                STEPS_PER_EPOCH)
    state = TrainState(model, opt)
    step = make_train_step(build_loss(hypes), sched, accum_steps=accum)
    n = batch["agent_mask"].shape[0]
    kw = {} if u is None else {"comm_u": torch.full((n,), float(u))}
    parts = step(state, batch_to_torch(batch, "cpu"), **kw)
    assert state.step == 1
    return model, {k: float(v) for k, v in parts.items()}


def twin(hypes, params, stats, double=False):
    """A port model holding a flax tree: the weight bridge is linear per
    leaf, so it carries gradients as it carries weights."""
    model = build_model(hypes, device="cpu")
    if double:
        model.double()
    load_flax_variables(model, {"params": params, "batch_stats": stats})
    return model


def run_both(jh, th, batch, variables, *, accum=1, u=None, ref64=False,
             compiler_options=None):
    """The two f32 steps: a dict of the port's model and parts, JAX's parts
    and the JAX gradients and updated variables carried into port twins.
    With ``ref64`` also JAX's float64 gradients (``grads64``), the reference
    of a config whose JAX f32 gradients lie further from its own float64
    ones than the f32 tolerance."""
    params, stats, jparts, jgrads = jax_step(
        jh, batch, variables, accum=accum, u=u,
        compiler_options=compiler_options)
    model, parts = port_step(th, batch, variables, accum=accum, u=u)
    run = dict(model=model, parts=parts, jparts=jparts,
               grads=twin(th, jgrads, stats), after=twin(th, params, stats))
    if ref64:
        _, stats64, _, grads64 = jax_step(
            jh, batch, variables, accum=accum, u=u, dtype=jnp.float64,
            compiler_options=compiler_options)
        run["grads64"] = twin(th, grads64, stats64, double=True)
    return run


def check_loss_parts(got, want, tol=STEP_LOSS_TOL):
    """Every loss part to ``tol`` relative (1e-6 absolute); returns the
    largest relative error."""
    assert set(got) == set(want)
    worst = 0.0
    for k in want:
        worst = max(worst, abs(got[k] - want[k]) / max(abs(want[k]), 1e-30))
        assert got[k] == pytest.approx(want[k], rel=tol, abs=1e-6), (k, worst)
    assert math.isfinite(want["total_loss"]) and want["total_loss"] > 0
    return worst


def check_gradients(model, grads_twin, tol=STEP_GRAD_TOL, floor=STEP_GRAD_FLOOR):
    """Every gradient leaf within ``tol`` of the leaf's scale plus ``floor``
    of the step's largest gradient (f32: JAX's own rounding of the small
    leaves; float64: ``floor`` 0). Returns the largest share of its bound
    that a leaf's error takes."""
    want = dict(grads_twin.named_parameters())
    top = max(np.abs(w.detach().numpy()).max() for w in want.values())
    assert top > 0
    worst = 0.0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        g, w = p.grad.numpy(), want[name].detach().numpy()
        err = np.abs(g - w).max()
        bound = tol * np.abs(w).max() + floor * top
        worst = max(worst, err / bound)
        assert err <= bound, (name, err, np.abs(w).max())
    return worst


def check_f64_gradients(model, grads_twin):
    check_gradients(model, grads_twin, F64_GRAD_TOL, 0.0)


def check_params_and_stats(model, after, grads_twin, min_clear=1000,
                           grad_tol=STEP_GRAD_TOL, stat_tol=1e-5):
    """Updated parameters: entries whose JAX gradient exceeds twice the
    gradient check's bound (``grad_tol`` of the leaf's scale plus
    STEP_GRAD_FLOOR of the step's largest) agree to 1e-6 (the first Adam
    step moves each by about lr, its sign sure); the rest within 2 lr.
    Every BN running statistic to ``stat_tol`` x (1 + |statistic|). Returns
    the statistics' count."""
    want = dict(after.named_parameters())
    grads = dict(grads_twin.named_parameters())
    top = max(np.abs(g.detach().numpy()).max() for g in grads.values())
    clear = 0
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].detach().numpy()
        g = grads[name].detach().numpy()
        sure = np.abs(g) > 2 * (grad_tol * np.abs(g).max() + STEP_GRAD_FLOOR * top)
        clear += int(sure.sum())
        err = np.abs(got - w)
        assert err[sure].max(initial=0) <= 1e-6 * (
            1 + np.abs(w[sure]).max(initial=0)), name
        assert err.max() <= 2 * LR + 1e-6, name
    assert clear > min_clear
    bufs = dict(after.named_buffers())
    n = 0
    for name, b in model.named_buffers():
        if name.endswith("num_batches_tracked") or name not in bufs:
            continue
        g, w = b.numpy(), bufs[name].numpy()
        assert np.all(np.abs(g - w) <= stat_tol * (1 + np.abs(w))), (
            name, np.abs(g - w).max())
        n += 1
    return n


# --- the tiny models and their labelled batch ------------------------------------

POSES = 2  # perturb_poses seed: the ROI samples clear ROI_MARGIN
ROI_MARGIN = 1e-4
VAR_SEED = 5


def tiny_hypes(load, name, task):
    """The tiny config (TINY) as ``name`` for ``task``, loaded by ``load``."""
    if name == "airv2x_v2xvit":
        hypes = copy.deepcopy(load(TINY))
        hypes["model"]["core_method"] = name
        hypes["model"]["args"]["transformer"] = {
            "encoder": copy.deepcopy(CHIP_SMOKE.TINY_V2XVIT_ENCODER)}
        hypes["task"] = hypes["model"]["args"]["task"] = task
        return hypes
    return CHIP_SMOKE.tiny_family_hypes(load(TINY), name, task)


def labelled_batch():
    """tests/test_torch_train.py's labelled batch (seed 3, seg labels at
    96 x 96) with the second sample's drone absent and perturbed poses."""
    hypes = jax_load_yaml(TINY)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    batch, _ = jax_make_batch(
        np.random.default_rng(3), JaxSlotLayout.from_args(hypes["model"]["args"]),
        2, anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=hypes["postprocess"]["target_args"], seg_hw=96,
        num_objects=4, points_per_agent=512,
        lidar_range=hypes["preprocess"]["cav_lidar_range"],
        max_boxes=hypes["postprocess"]["max_num"], pts_per_box=40)
    batch["agent_mask"][1, 3] = False
    batch["points_mask"][1, 3] = False
    return perturb_poses(batch, np.random.default_rng(POSES))


def roi_margins(batch):
    """The V2X-ViT and V2VNet ROI samples' smallest distance from 0.5."""
    v2x = tiny_hypes(load_yaml, "airv2x_v2xvit", "det")
    v2v = tiny_hypes(load_yaml, "airv2x_v2vnet", "det")
    return {"v2xvit": float((CHIP_SMOKE.roi_samples(
                v2x, torch.from_numpy(batch["pairwise_t"]), (48, 48))
                - 0.5).abs().min()),
            "v2vnet": CHIP_SMOKE.v2vnet_roi_margin(
                v2v, torch.from_numpy(batch["pairwise_t_full"]))}


def variables_for(jh, batch):
    """The flax variables of ``jh``'s model, seeded numpy values
    (``random_variables``, seed VAR_SEED)."""
    scene = {k: v for k, v in batch.items() if k != "labels"}
    return random_variables(jax_build_model(jh), jax.tree.map(jnp.asarray, scene),
                            seed=VAR_SEED, train=False)



