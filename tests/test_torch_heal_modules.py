"""The modules of HEAL, STAMP and SiCP in the PyTorch port against the JAX
package on the CPU: the normalized warp in both ``align_corners`` branches,
the ResNeXt ``BottleneckX`` and stage (eval, and train mode with its BN
statistics), the ResNet backbone without deblocks, HEAL's ``weighted_fuse``
(masked agents, zero-score pixels), ``cam_crop_mask`` and
``PyramidFusion``, each STAMP adapter at the shipped geometry (ratio 1)
and at one that shrinks, pads and crops, SiCP's ``SpatialFusion`` (in =
out, in != out, a lone ego, masked senders) and both loss variants.

Weights pass through the bridge from seeded flax variables; inputs come
from a numpy seed. XLA's CPU jit (jax 0.9.0) miscompiles the JAX
``weighted_fuse``: jitted alone it lies 14.66 off its eager value at a
scale of 37.5 on the tiny HEAL model's first level (ROADMAP §3), so every
JAX call but the fuse's and the pyramid's (eager) is compiled without
LLVM's optimisations (``XLA_OPT0``; eagerly each primitive compiles alone,
~10x slower), and the DSA adapter runs eagerly too (at ``XLA_OPT0`` its
output moves by 1.1e-4 at a scale of 8.6). Every warp's samples are
asserted to decide the
footprint's edge (HEAL's score != 0, SiCP's overlap > 0) more than MARGIN
pixels from it (``chip_smoke.py:warp_footprint_margin``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models.fusion import adapter as jad
from airv2x_tpu.models.fusion import pyramid as jpyr
from airv2x_tpu.models.fusion import sicp as jsicp
from airv2x_tpu.models import resnet_bev as jres
from airv2x_tpu.ops import warp as jwarp
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import resnet_bev as tres
from airv2x_tpu_torch.models.fusion import adapter as tad
from airv2x_tpu_torch.models.fusion import pyramid as tpyr
from airv2x_tpu_torch.models.fusion import sicp as tsicp
from airv2x_tpu_torch.ops import warp as twarp
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_intermediate import _nchw, _nhwc, _poses, _x
from tests.torch_port_helpers import (
    CHIP_SMOKE, assert_close, one_torch_thread, random_variables)
from tests.torch_train_helpers import XLA_OPT0

TOL = 1e-5  # module outputs, f32, x (1 + scale)
MARGIN = 1e-4  # source pixels between a warp's samples and a footprint edge
AGENT_MASK = np.array([[True, True, False, True], [True, False, True, True]])
TINY_RANGE = [-19.2, -19.2, -3, 19.2, 19.2, 1]


def _close(got, want, what, tol=TOL):
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert_close(got, want, tol * (1 + scale), 0, what)


def _affines(seed, b, l, h, w, ds=2):
    """(b, l, 2, 3) normalized affines (numpy) of ``perturb_poses``' poses
    (slot 0 the identity), at an (h, w) map, 0.4 m cells, stride ``ds``."""
    pt = _poses(seed, b, l)[:, 0]
    return np.asarray(jwarp.normalized_pairwise_affine(
        jnp.asarray(pt), h, w, 0.4, ds)), pt


def _jax(fn, *args):
    """``fn(*args)`` (arrays in, static values closed over) jitted at
    ``XLA_OPT0``."""
    return jax.jit(fn).lower(*args).compile(XLA_OPT0)(*args)


def _module(jmod, tmod, jx, tx, seed, train=False, **kw):
    """Seeded flax variables into both modules -> (port output, JAX output,
    variables, JAX new batch_stats or None)."""
    var = random_variables(jmod, jx, seed=seed, **kw)
    load_flax_variables(tmod, var)
    tmod.train(train)
    if train:
        want, upd = _jax(lambda v, x: jmod.apply(v, x, train=True,
                                                 mutable=["batch_stats"]),
                         var, jx)
    else:
        want, upd = _jax(lambda v, x: jmod.apply(v, x, **kw), var, jx), None
    with torch.no_grad():
        got = tmod(tx)
    return got, want, var, upd


# --- the normalized warp ------------------------------------------------------

@pytest.mark.parametrize("align_corners", [False, True])
def test_warp_affine_normalized_matches_jax(align_corners):
    src = _x(1, (2, 4, 12, 16, 5))
    aff, _ = _affines(3, 2, 4, 12, 16)
    want = _jax(lambda s, a: jwarp.warp_affine_normalized(s, a, align_corners),
                src, aff)
    got = twarp.warp_affine_normalized(torch.from_numpy(src),
                                       torch.from_numpy(aff),
                                       align_corners=align_corners)
    _close(got.numpy(), want, f"warp align_corners={align_corners}")
    assert CHIP_SMOKE.warp_footprint_margin(
        torch.from_numpy(aff), 12, 16, align_corners) > MARGIN
    if not align_corners:  # the default is the False branch, unchanged
        same = twarp.warp_affine_normalized(torch.from_numpy(src),
                                            torch.from_numpy(aff))
        assert torch.equal(same, got)


def test_align_corners_branches_differ_off_the_identity():
    """The two branches agree at the identity (every sample on its own
    pixel) and not elsewhere."""
    src = torch.from_numpy(_x(2, (1, 6, 8, 3)))
    eye = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0]]])
    for ac in (False, True):
        torch.testing.assert_close(
            twarp.warp_affine_normalized(src, eye, align_corners=ac), src,
            rtol=0, atol=1e-6)
    aff = torch.from_numpy(_affines(4, 1, 2, 6, 8)[0][:, 1])
    a, b = (twarp.warp_affine_normalized(src, aff, align_corners=ac)
            for ac in (False, True))
    assert (a - b).abs().max() > 0.1


# --- the ResNet trunk -----------------------------------------------------------

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bottleneckx_matches_jax(train):
    """planes 64 (width 128, 32 groups of 4), stride 2 with the projected
    identity; in train mode the outputs and the updated BN statistics."""
    x = _x(5, (2, 12, 10, 48))
    jmod = jres.BottleneckX(64, 2, downsample=True)
    tmod = tres.BottleneckX(48, 64, 2, downsample=True)
    assert tmod.conv1.groups == 32 and tmod.conv1.out_channels == 128
    got, want, var, upd = _module(jmod, tmod, jnp.asarray(x), _nchw(x[:, None])[:, 0],
                                  6, train=train)
    _close(_nhwc(got), want, "BottleneckX")
    if train:
        stats = dict(tmod.named_buffers())
        for name, bn in (("bn0", "BatchNorm_0"), ("bn1", "BatchNorm_1"),
                         ("bn2", "BatchNorm_2"), ("down_bn", "BatchNorm_3")):
            for t, f in (("running_mean", "mean"), ("running_var", "var")):
                w = np.asarray(upd["batch_stats"][bn][f])
                assert np.abs(w - np.asarray(var["batch_stats"][bn][f])).max() > 0
                _close(stats[f"{name}.{t}"].numpy(), w, f"{name}.{t}", 1e-6)


def test_resnext_stage_matches_jax():
    x = _x(7, (1, 8, 8, 32))
    jmod = jres.ResNetStage(planes=64, blocks=3, stride=1, in_planes=32,
                            resnext=True)
    tmod = tres.ResNetStage(32, 64, 3, 1, resnext=True)
    got, want, _, _ = _module(jmod, tmod, jnp.asarray(x),
                              _nchw(x[:, None])[:, 0], 8)
    _close(_nhwc(got), want, "ResNeXt stage")


def test_backbone_without_deblocks_returns_the_last_stage():
    """HEAL's modality backbone (``upsample_strides: []``): the decoded map
    is the last stage's output; its input width (16) differs from the
    config's ``inplanes`` (64), which decides the identity projection."""
    x = _x(9, (2, 16, 20, 16))
    kw = dict(layer_nums=[2], layer_strides=[2], num_filters=[24],
              upsample_strides=[], num_upsample_filters=[], inplanes=64)
    jmod = jres.ResNetBEVBackbone(**kw)
    tmod = tres.ResNetBEVBackbone(**kw, in_ch=16)
    assert tmod.out_channels == 24
    var = random_variables(jmod, jnp.asarray(x), seed=10)
    load_flax_variables(tmod, var)
    want, wfeats = _jax(jmod.apply, var, jnp.asarray(x))
    with torch.no_grad():
        got, feats = tmod.eval()(_nchw(x[:, None])[:, 0])
    _close(_nhwc(got), want, "no-deblock backbone")
    assert got is feats[-1] and len(wfeats) == 1


# --- HEAL's pyramid -----------------------------------------------------------

def _fuse_inputs(seed, zero_scores=True):
    feats = _x(seed, (2, 4, 10, 12, 6))
    scores = np.abs(_x(seed + 1, (2, 4, 10, 12, 1))) + 1e-4
    if zero_scores:  # zero-score pixels of present agents: left out (not
        # the ego's: its identity warp samples within an ulp of its pixels,
        # where a zero block's edge is decided by the coordinates' rounding)
        scores[0, 1, :3] = 0.0
        scores[1, 3, 4:6, 2:9] = 0.0
    aff, _ = _affines(seed + 2, 2, 4, 10, 12)
    return feats, scores, aff


@pytest.mark.parametrize("align_corners", [False, True])
def test_weighted_fuse_matches_jax(align_corners):
    feats, scores, aff = _fuse_inputs(11)
    want = jpyr.weighted_fuse(jnp.asarray(feats), jnp.asarray(scores),
                              jnp.asarray(AGENT_MASK), jnp.asarray(aff),
                              align_corners)
    got = tpyr.weighted_fuse(torch.from_numpy(feats), torch.from_numpy(scores),
                             torch.from_numpy(AGENT_MASK), torch.from_numpy(aff),
                             align_corners)
    _close(got.numpy(), want, "weighted_fuse")
    assert CHIP_SMOKE.warp_footprint_margin(
        torch.from_numpy(aff[AGENT_MASK]), 10, 12, align_corners) > MARGIN
    # a pixel where no agent counts is 0: sample 1's ego scores zeroed there
    # and its other present agents' footprints moved off it
    assert np.abs(np.asarray(want)).max() > 0


def test_weighted_fuse_leaves_out_absent_agents_and_zero_scores():
    """An absent agent's features do not reach the output, whatever they
    hold; a present agent whose score is 0 everywhere does not either."""
    feats, scores, aff = _fuse_inputs(12, zero_scores=False)
    t = {k: torch.from_numpy(v) for k, v in
         (("f", feats), ("s", scores), ("a", aff), ("m", AGENT_MASK))}
    base = tpyr.weighted_fuse(t["f"], t["s"], t["m"], t["a"])
    moved = t["f"].clone()
    moved[0, 2] += 100.0  # absent in sample 0
    assert torch.equal(tpyr.weighted_fuse(moved, t["s"], t["m"], t["a"]), base)
    s0 = t["s"].clone()
    s0[1, 2] = 0.0  # present in sample 1, scored 0
    moved = t["f"].clone()
    moved[1, 2] += 100.0
    torch.testing.assert_close(
        tpyr.weighted_fuse(moved, s0, t["m"], t["a"])[1],
        tpyr.weighted_fuse(t["f"], s0, t["m"], t["a"])[1], rtol=0, atol=0)


def test_cam_crop_mask_matches_jax():
    """LiDAR agents (ratio <= 0) keep the whole map, camera agents the
    central ``dim / ratio - 4`` window; exact. Both packages floor the
    window's ends as the reference does, so along an odd axis a LiDAR
    agent's window loses its last row or column (25 -> rows 0-23)."""
    ratios = np.array([[[0.0, 0.0], [2.0, 2.0], [-1.0, 3.3]],
                       [[1.5, 4.0], [0.0, 2.5], [7.0, 1.0]]], np.float32)
    for h, w in ((32, 32), (25, 88), (100, 352)):
        want = np.asarray(jpyr.cam_crop_mask(h, w, jnp.asarray(ratios)))
        got = tpyr.cam_crop_mask(h, w, torch.from_numpy(ratios)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[0, 0].sum() == (h - h % 2) * (w - w % 2)
        assert got[0, 1].sum() < h * w


PYRAMID = {"resnext": True, "layer_nums": [2, 1], "layer_strides": [1, 2],
           "num_filters": [32, 64], "upsample_strides": [1, 2],
           "num_upsample_filter": [16, 16], "inplanes": 16}


@pytest.mark.parametrize("case", ["plain", "cam_crop", "align_corners"])
def test_pyramid_fusion_matches_jax(case):
    """``forward_collab`` (fused map and occupancy logits) and
    ``forward_single`` through the bridge, at 12 x 16 maps of 4 agents."""
    args = dict(PYRAMID, align_corners=case == "align_corners")
    x = _x(13, (2, 4, 12, 16, 16))
    _, pt = _affines(14, 2, 4, 12, 16)
    crop = None
    if case == "cam_crop":
        crop = np.zeros((2, 4, 2), np.float32)
        crop[:, 1:] = 2.0
    jmod, tmod = jpyr.PyramidFusion(args=args, inplanes=16), tpyr.PyramidFusion(args)
    jargs = (jnp.asarray(x), jnp.asarray(AGENT_MASK), jnp.asarray(pt), 0.4, 2)
    var = random_variables(jmod, *jargs, seed=15, method="forward_collab")
    load_flax_variables(tmod, var)
    tmod.eval()
    want, wocc = jmod.apply(var, *jargs, cam_crop_ratios=None if crop is None
                            else jnp.asarray(crop), method="forward_collab")
    with torch.no_grad():
        got, occ = tmod.forward_collab(
            _nchw(x), torch.from_numpy(AGENT_MASK), torch.from_numpy(pt), 0.4,
            2, cam_crop_ratios=None if crop is None else torch.from_numpy(crop))
    _close(_nhwc(got), want, f"pyramid {case}")
    for i, (o, w) in enumerate(zip(occ, wocc)):
        _close(_nhwc(o), w, f"occupancy level {i}")
    for i, (h, w) in enumerate(((12, 16), (6, 8))):
        aff = twarp.normalized_pairwise_affine(torch.from_numpy(pt), h, w, 0.4, 2)
        assert CHIP_SMOKE.warp_footprint_margin(
            aff[torch.from_numpy(AGENT_MASK)], h, w, args["align_corners"]) > MARGIN
    want1, wocc1 = _jax(lambda v, a: jmod.apply(v, a, method="forward_single"),
                        var, jnp.asarray(x[:, 0]))
    with torch.no_grad():
        got1, occ1 = tmod.forward_single(_nchw(x[:, :1])[:, 0])
    _close(_nhwc(got1), want1, "forward_single")
    _close(_nhwc(occ1[1]), wocc1[1], "forward_single occupancy")


# --- STAMP's adapters ------------------------------------------------------------

SHIPPED = {"in_cav_lidar_range": TINY_RANGE, "out_cav_lidar_range": TINY_RANGE,
           "in_feature_shape": [24, 24], "out_feature_shape": [24, 24]}
# resized by (1, 0.5) to 12 x 24, then 2 columns cropped per side and 2 rows
# padded per side: 16 x 20
RESHAPED = {"in_cav_lidar_range": TINY_RANGE,
            "out_cav_lidar_range": [-16.0, -25.6, -3, 16.0, 25.6, 1],
            "in_feature_shape": [24, 24], "out_feature_shape": [16, 20]}
# ratio 1, 2 columns cropped and 2 rows padded per side: 28 x 20
CROPPED = {"in_cav_lidar_range": TINY_RANGE,
           "out_cav_lidar_range": [-16.0, -22.4, -3, 16.0, 22.4, 1],
           "in_feature_shape": [24, 24], "out_feature_shape": [28, 20]}
GEOMETRIES = {"shipped": SHIPPED, "reshaped": RESHAPED, "cropped": CROPPED}
SUB = {"dim": 16, "depth": 2, "n_layers": 2, "num_heads": 4, "num_points": 2}


def _adapter_cfg(variant, geometry, out_channels=16):
    return {"core_method": variant,
            "args": dict(GEOMETRIES[geometry],
                         in_channels=16, out_channels=out_channels,
                         submodule_args=dict(SUB))}


def test_adapter_geometry_matches_jax():
    for geometry in GEOMETRIES.values():
        ratio, pads = tad._geometry(dict(geometry))
        jratio, jpads = jad._geometry(dict(geometry))
        np.testing.assert_array_equal(ratio, jratio)
        assert pads == jpads
    assert tuple(tad._geometry(dict(SHIPPED))[0]) == (1.0, 1.0)
    ratio, pads = tad._geometry(dict(RESHAPED))
    assert tuple(ratio) == (1.0, 0.5) and pads == (-2, -2, 2, 2)
    ratio, pads = tad._geometry(dict(CROPPED))
    assert tuple(ratio) == (1.0, 1.0) and pads == (-2, -2, 2, 2)


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("variant", ["identity", "identity-8", "adapterconv",
                                     "adapterfc", "adapterconvnext",
                                     "adapterdsa"])
def test_adapter_matches_jax(variant, geometry):
    """Each variant at the shipped geometry (ratio 1), one that shrinks the
    rows by half, crops and pads, and one that only crops and pads. The DSA
    adapter samples its reference points on the source grid, so where the
    resize changes the query grid both packages refuse the shapes."""
    name, _, out_c = variant.partition("-")
    if name == "adapterdsa" and geometry == "reshaped":
        cfg = _adapter_cfg(name, geometry)
        x = _x(17, (2, 24, 24, 16))
        jmod = jad.Adapter(cfg=cfg)
        with pytest.raises(TypeError, match="broadcasting"):
            jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
        with pytest.raises(RuntimeError):
            tad.Adapter(cfg)(_nchw(x[:, None])[:, 0])
        return
    cfg = _adapter_cfg(name, geometry, int(out_c or 16))
    x = _x(17, (2, 24, 24, 16))
    jmod, tmod = jad.Adapter(cfg=cfg), tad.Adapter(cfg)
    var = random_variables(jmod, jnp.asarray(x), seed=18) if name != "identity" else {}
    load_flax_variables(tmod, var)
    want = (jmod.apply(var, jnp.asarray(x)) if name == "adapterdsa"
            else _jax(jmod.apply, var, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod.eval()(_nchw(x[:, None])[:, 0])
    _close(_nhwc(got), want, f"{variant} {geometry}")
    # the ConvNeXt variant resizes but neither crops nor pads
    shape = {"shipped": (24, 24), "cropped": (
        (24, 24) if name == "adapterconvnext" else (28, 20)), "reshaped": (
        (12, 24) if name == "adapterconvnext" else (16, 20))}[geometry]
    assert tuple(got.shape) == (2, int(out_c or 16)) + shape


def test_adapter_unknown_variant_raises():
    with pytest.raises(NotImplementedError):
        tad.Adapter({"core_method": "reverter", "args": dict(SHIPPED)})


# --- SiCP's gate --------------------------------------------------------------

@pytest.mark.parametrize("case", ["in_eq_out", "in_ne_out", "lone_ego",
                                  "masked_senders"])
def test_spatial_fusion_matches_jax(case):
    c, out = 8, (8 if case != "in_ne_out" else 6)
    mask = {"lone_ego": np.array([[True, False, False], [True, False, False]]),
            "masked_senders": np.array([[True, False, True], [True, True, False]])
            }.get(case, np.ones((2, 3), bool))
    x = _x(19, (2, 3, 12, 14, c))
    full = _poses(20, 2, 3)
    jmod = jsicp.SpatialFusion(in_channels=2 * c, out_channels=out)
    tmod = tsicp.SpatialFusion(2 * c, out)
    kw = dict(discrete_ratio=0.4, downsample_rate=2)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(full))
    var = random_variables(jmod, *jargs, seed=21, **kw)
    load_flax_variables(tmod, var)
    want = _jax(lambda v, *a: jmod.apply(v, *a, **kw), var, *jargs)
    with torch.no_grad():
        got = tmod.eval()(_nchw(x), torch.from_numpy(mask),
                          torch.from_numpy(full), **kw)
    _close(_nhwc(got), want, f"SpatialFusion {case}")
    if case == "lone_ego" and c == out:
        np.testing.assert_array_equal(_nhwc(got), x[:, 0])
    aff = twarp.normalized_pairwise_affine(torch.from_numpy(full[:, 0, 1:]),
                                           12, 14, 0.4, 2)
    assert CHIP_SMOKE.warp_footprint_margin(
        aff[torch.from_numpy(mask[:, 1:])], 12, 14) > MARGIN


def test_spatial_fusion_train_statistics_chain_per_sender():
    """In train mode every sender slot (an absent one too) runs the gate's
    modules once, each BN update chained on the last, as flax's are."""
    c = 4
    mask = np.array([[True, True, False], [True, False, True]])
    x = _x(22, (2, 3, 8, 8, c))
    full = _poses(23, 2, 3)
    jmod = jsicp.SpatialFusion(in_channels=2 * c, out_channels=6)
    tmod = tsicp.SpatialFusion(2 * c, 6)
    kw = dict(discrete_ratio=0.4, downsample_rate=2)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(full))
    var = random_variables(jmod, *jargs, seed=24, **kw)
    load_flax_variables(tmod, var)
    want, upd = _jax(lambda v, *a: jmod.apply(v, *a, **kw, train=True,
                                              mutable=["batch_stats"]),
                     var, *jargs)
    with torch.no_grad():
        got = tmod.train()(_nchw(x), torch.from_numpy(mask),
                           torch.from_numpy(full), **kw)
    _close(_nhwc(got), want, "SpatialFusion train", 1e-4)
    bufs = dict(tmod.named_buffers())
    for i, name in enumerate(("comp1", "conv1", "conv2", "comp2")):
        for t, f in (("running_mean", "mean"), ("running_var", "var")):
            w = np.asarray(upd["batch_stats"][f"_ConvBN_{i}"]["BatchNorm_0"][f])
            _close(bufs[f"{name}.bn.{t}"].numpy(), w, f"{name} {t}", 1e-5)


# --- the loss variants ----------------------------------------------------------

def _det_outputs(rng, prefixes, multiclass):
    out = {}
    for p in prefixes:
        out[f"psm{p}"] = rng.normal(size=(2, 6, 8, 14 if multiclass else 2))
        out[f"rm{p}"] = rng.normal(size=(2, 6, 8, 14))
        if multiclass:
            out[f"obj{p}"] = rng.normal(size=(2, 6, 8, 2))
    return {k: v.astype(np.float32) for k, v in out.items()}


@pytest.mark.parametrize("kind", ["multiclass", "binary"])
@pytest.mark.parametrize("dual", [True, False], ids=["dual", "plain"])
def test_sicp_loss_matches_jax(kind, dual):
    """``point_pillar_loss_sicp_multiclass`` (``num_class``) and
    ``point_pillar_loss_sicp`` (binary): on SiCP's train-mode heads the sum
    of the two heads' losses with every part named per head; on plain
    outputs the base loss."""
    rng = np.random.default_rng(25)
    multi = kind == "multiclass"
    out = _det_outputs(rng, ("1", "2", "") if dual else ("",), multi)
    pos = (rng.uniform(size=(2, 6, 8, 2)) < 0.05).astype(np.float32)
    tgt = {"pos_equal_one": pos,
           "targets": rng.normal(size=(2, 6, 8, 14)).astype(np.float32),
           "class_ids": rng.integers(0, 7, (2, 6, 8, 2)).astype(np.int32)}
    args = {"cls_weight": 1.0, "reg": 2.0}
    if multi:
        args["num_class"] = 7
    cfg = {"loss": {"core_method": "point_pillar_loss_sicp_multiclass"
                    if multi else "point_pillar_loss_sicp", "args": args},
           "model": {"args": {}}}
    _, want = jax_build_loss(cfg)(jax.tree.map(jnp.asarray, out),
                                  jax.tree.map(jnp.asarray, tgt))
    _, got = build_loss(cfg)({k: torch.from_numpy(v) for k, v in out.items()},
                             {k: torch.from_numpy(v) for k, v in tgt.items()})
    assert set(got) == set(want)
    if dual:
        assert {"total_loss1", "total_loss2", "reg_loss1"} <= set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


@pytest.mark.parametrize("keys", ["all", "fm_only", "none"])
def test_adapter_loss_matches_jax(keys):
    rng = np.random.default_rng(26)
    names = {"all": ("adapted", "protocol", "reverted", "ego_feature", "cycled"),
             "fm_only": ("adapted", "protocol"), "none": ("psm",)}[keys]
    out = {k: rng.normal(size=(2, 4, 5, 3)).astype(np.float32) for k in names}
    cfg = {"loss": {"core_method": "adapter_loss",
                    "args": {"fm": 0.5, "p2m": 2.0, "fp2m": 1.5}},
           "model": {"args": {}}}
    _, want = jax_build_loss(cfg)(jax.tree.map(jnp.asarray, out), {})
    _, got = build_loss(cfg)({k: torch.from_numpy(v) for k, v in out.items()}, {})
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=0), k
    if keys == "none":
        assert float(got["total_loss"]) == 0.0
