"""The V2X-ViT path of the PyTorch port against the JAX package: the STTF
warp (airv2x_tpu_torch/ops/warp.py), every fusion module through the weight
bridge (models/fusion/v2xvit.py), and the tiny Airv2xV2XViT det and seg
models in both conv modes, f32 and bf16.

``make_scene``'s poses are the identity and its delays 0, which would hide
the warp, the ROI mask and the temporal encoding: every test here feeds
poses of up to 5 degrees and 3 m per slot and delays 0-3, drawn from a
seeded numpy generator (``perturb_poses``)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.data.postprocess import decode_segmentation as jax_decode_seg
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.fusion import v2xvit as jv
from airv2x_tpu.ops import warp as jwarp
from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.postprocess import (
    decode_detections, decode_segmentation)
from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion import v2xvit as tv
from airv2x_tpu_torch.models.v2xvit_model import Airv2xV2XViT
from airv2x_tpu_torch.ops import warp as twarp
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.utils.weights import cast_weights_, load_flax_variables
from tests.torch_port_helpers import (
    TINY, TINY_PWINDOW, assert_close, jnp_tree, load_chip_smoke,
    one_torch_thread, random_variables, tiny_seg, tiny_v2xvit,
    tiny_v2xvit_encoder)



TOL = 1e-5  # modules and the warp, x (1 + scale): f32 sums in another order
TOL_MODEL = 1e-4  # whole-model outputs through ~20 conv layers and the
#                   transformer, f32, x (1 + scale)
# a bilinear sample of the ones canvas this close to 0.5 could fall on the
# other side of the ROI threshold in one of the two packages
ROI_MARGIN = 1e-4
TOP_K = 256
# bf16 whole-model eval against JAX bf16, x (1 + scale). Measured on the
# tiny det model (scene seed 0, poses seed 1, variables seed 31): the port's
# bf16 psm / rm / obj lie 0.297 / 0.375 / 0.230 (auto) and 0.313 / 0.359 /
# 0.261 (pallas) from JAX bf16 at scales 14.9 / 13.9 / 9.6, at most 0.0252
# x (1 + scale); JAX's own bf16 lies 0.268 / 0.268 / 0.168 from its f32
# outputs, the port's 0.297 / 0.270 / 0.190 (auto) and 0.247 / 0.273 /
# 0.182 (pallas): both sides' bf16 rounding through the backbone and three
# attention stages. The bound leaves twice the measured room.
BF16_TOL = 0.05
WINDOWS = [3, 2]
WIN_IDS = ["split_attn-3", "naive-2"]


def _poses(seed, b, l):
    """(b, l, 4, 4) poses and (b, l, 3) prior encodings from
    ``perturb_poses``: slot 0 identity, the others a few degrees and metres
    off, delays 0-3; the infra flag of every second slot set."""
    batch = {"pairwise_t": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (b, l, 4, 4)).copy(),
             "prior_encoding": np.zeros((b, l, 3), np.float32)}
    perturb_poses(batch, np.random.default_rng(seed))
    batch["prior_encoding"][:, 1::2, 2] = 1.0
    batch["prior_encoding"][..., 0] = 7.5  # velocity, read by no module
    return batch["pairwise_t"], batch["prior_encoding"]


def _roi_margin(shape_hw, pairwise_t, ratio, down):
    """The smallest distance of a JAX ROI sample from the 0.5 threshold."""
    h, w = shape_hw
    b, l = pairwise_t.shape[:2]
    m = jwarp.center_pixel_affine(
        jwarp.discretized_transform(jnp.asarray(pairwise_t), ratio, down), (h, w))
    ones = jnp.ones((b, l, h, w, 1), jnp.float32)
    samples = np.asarray(jwarp.warp_affine(ones, m, (h, w)))
    return float(np.abs(samples - 0.5).min())


# --- the STTF warp ---------------------------------------------------------

def test_pixel_affines_match_jax():
    pt, _ = _poses(1, 2, 4)
    want = np.array(jwarp.discretized_transform(jnp.asarray(pt), 0.4, 2))
    got = twarp.discretized_transform(torch.from_numpy(pt), 0.4, 2).numpy()
    assert_close(got, want, TOL, TOL, "discretized_transform")
    want_c = np.array(jwarp.center_pixel_affine(jnp.asarray(want), (24, 40)))
    got_c = twarp.center_pixel_affine(torch.from_numpy(want), (24, 40)).numpy()
    assert_close(got_c, want_c, TOL, TOL, "center_pixel_affine")
    assert np.abs(want[:, 1:, :, 2]).max() > 1.0  # translated by pixels


@pytest.mark.parametrize("dsize", [(12, 16), (10, 20)])
def test_warp_affine_matches_jax(dsize):
    rng = np.random.default_rng(4)
    src = rng.normal(0, 1, (2, 3, 12, 16, 5)).astype(np.float32)
    pt, _ = _poses(2, 2, 3)
    m = np.array(jwarp.center_pixel_affine(
        jwarp.discretized_transform(jnp.asarray(pt), 0.4, 1), (12, 16)))
    m[0, 1, 0, 0] = m[0, 1, 1, 1] = 0.0  # a singular block: divides by 1
    m[0, 1, 0, 1] = m[0, 1, 1, 0] = 0.0
    want = np.asarray(jwarp.warp_affine(jnp.asarray(src), jnp.asarray(m), dsize))
    got = twarp.warp_affine(torch.from_numpy(src), torch.from_numpy(m),
                            dsize).numpy()
    assert got.shape == want.shape == (2, 3) + dsize + (5,)
    assert_close(got, want, TOL * (1 + np.abs(want).max()), 0, "warp_affine")


def test_warp_bev_features_matches_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (2, 4, 24, 40, 8)).astype(np.float32)
    pt, _ = _poses(3, 2, 4)
    want = np.asarray(jwarp.warp_bev_features(jnp.asarray(feats),
                                              jnp.asarray(pt), 0.4, 2))
    got = twarp.warp_bev_features(torch.from_numpy(feats),
                                  torch.from_numpy(pt), 0.4, 2).numpy()
    np.testing.assert_array_equal(got[:, 0], feats[:, 0])  # the ego as it is
    assert_close(got, want, TOL * (1 + np.abs(want).max()), 0,
                 "warp_bev_features")
    assert np.abs(want[:, 1:] - feats[:, 1:]).max() > 0.5  # really warped
    # a bf16 map sampled on the f32 grid comes out f32, as in JAX
    bf = twarp.warp_bev_features(torch.from_numpy(feats).bfloat16(),
                                 torch.from_numpy(pt), 0.4, 2)
    assert bf.dtype == torch.float32


def test_rotated_roi_mask_matches_jax():
    pt, _ = _poses(1, 2, 4)
    margin = _roi_margin((48, 48), pt, 0.4, 2)
    assert margin > ROI_MARGIN, f"an ROI sample lies {margin:.2e} from 0.5"
    want = np.asarray(jwarp.rotated_roi_mask((48, 48), jnp.asarray(pt), 0.4, 2))
    got = twarp.rotated_roi_mask((48, 48), torch.from_numpy(pt), 0.4, 2).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[:, 0].all() and not want[:, 1:].all()  # borders cut off


# --- the fusion modules through the bridge ---------------------------------

def _check_module(jmod, tmod, jargs, targs, seed, what):
    """Seeded flax variables into both modules; outputs within TOL."""
    var = random_variables(jmod, *jargs, seed=seed)
    want = np.asarray(jmod.apply(var, *jargs))
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = tmod(*targs).numpy()
    scale = np.abs(want).max()
    assert scale > 0
    assert_close(got, want, TOL * (1 + scale), 0, what)
    return got, want


def _x(seed, shape=(2, 4, 8, 12, 64)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _mask(b=2, h=8, w=12, l=4):
    """(B, H, W, L): slot 3 of sample 1 absent, and at a few pixels of
    sample 0 every agent masked (a row JAX softmaxes to uniform)."""
    mask = np.ones((b, h, w, l), np.float32)
    mask[1, :, :, 3] = 0.0
    mask[0, 2, 3:6, :] = 0.0
    mask[0, 5, 7, 1:] = 0.0
    return mask


def test_rte_matches_jax():
    x = _x(10)
    dts = np.array([[0, 1, 3, 2], [0, 60, 1, 0]], np.int32)  # 60 clips at 99
    np.testing.assert_array_equal(tv.rte_table(64, 100),
                                  _rte_table_of_jax(64, 100))
    got, want = _check_module(
        jv.RTE(64, 2), tv.RTE(64, 2), (jnp.asarray(x), jnp.asarray(dts)),
        (torch.from_numpy(x), torch.from_numpy(dts)), 11, "RTE")
    assert np.abs(want - x).max() > 0.1


def _rte_table_of_jax(dim, max_len):
    """The table the JAX RTE adds before its Dense, read off a zero-weight
    Dense with the identity kernel."""
    mod = jv.RTE(dim, 1, max_len)
    var = {"params": {"lin": {"kernel": jnp.eye(dim), "bias": jnp.zeros(dim)}}}
    x = jnp.zeros((1, max_len, 1, 1, dim))
    dts = jnp.arange(max_len)[None]
    with jax.default_matmul_precision("highest"):
        return np.asarray(mod.apply(var, x, dts))[0, :, 0, 0]


def test_cav_attention_matches_jax():
    x, mask = _x(12), _mask()
    _check_module(jv.CavAttention(64, 4, 16), tv.CavAttention(64, 4, 16),
                  (jnp.asarray(x), jnp.asarray(mask)),
                  (torch.from_numpy(x), torch.from_numpy(mask)), 13,
                  "CavAttention")


def test_hgt_attention_matches_jax():
    """Mixed types, a masked slot, and pixels with every agent masked."""
    x, mask = _x(14), _mask()
    types = np.array([[0, 1, 0, 1], [1, 0, 0, 1]], np.int32)
    kw = dict(types=jnp.asarray(types))
    jmod = jv.HGTCavAttention(64, 4, 16)
    var = random_variables(jmod, jnp.asarray(x), jnp.asarray(mask), seed=15,
                           **kw)
    want = np.asarray(jmod.apply(var, jnp.asarray(x), jnp.asarray(mask), **kw))
    tmod = tv.HGTCavAttention(64, 4, 16)
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask),
                   torch.from_numpy(types)).numpy()
    assert_close(got, want, TOL * (1 + np.abs(want).max()), 0, "HGT")
    # the relation tensors are copied as they are, not transposed
    np.testing.assert_array_equal(tmod.relation_att.detach().numpy(),
                                  var["params"]["relation_att"])
    # each agent's type picks its Linears: swapping the types moves outputs
    with torch.no_grad():
        other = tmod(torch.from_numpy(x), torch.from_numpy(mask),
                     torch.from_numpy(1 - types)).numpy()
    assert np.abs(other - got).max() > 0.1


@pytest.mark.parametrize("ws,relative", [(2, True), (4, True), (2, False)])
def test_window_attention_matches_jax(ws, relative):
    x = _x(16, (1, 2, 8, 12, 64))
    _check_module(jv.BaseWindowAttention(64, 4, 16, ws, relative),
                  tv.BaseWindowAttention(64, 4, 16, ws, relative),
                  (jnp.asarray(x),), (torch.from_numpy(x),), 17,
                  f"BaseWindowAttention ws {ws}")


def test_window_relative_bias_sign():
    """rel[i, j] = idx[j] - idx[i] + ws - 1, idx over (x, y) with x outer:
    the bias of query 0 to key 1 (y + 1) reads pos[ws - 1, ws]."""
    mod = tv.BaseWindowAttention(8, 1, 8, 3)
    assert (int(mod.rel_a[0, 1]), int(mod.rel_b[0, 1])) == (2, 3)
    assert (int(mod.rel_a[1, 0]), int(mod.rel_b[1, 0])) == (2, 1)
    assert (int(mod.rel_a[0, 3]), int(mod.rel_b[0, 3])) == (3, 2)


def test_split_attn_matches_jax():
    xs = [_x(20 + i, (1, 2, 8, 12, 64)) for i in range(3)]
    _check_module(jv.SplitAttn(64), tv.SplitAttn(64),
                  ([jnp.asarray(a) for a in xs],),
                  ([torch.from_numpy(a) for a in xs],), 23, "SplitAttn")
    with pytest.raises(ValueError, match="3 branches"):
        tv.SplitAttn(64)([torch.from_numpy(a) for a in xs[:2]])


@pytest.mark.parametrize("windows", WINDOWS, ids=WIN_IDS)
def test_pyramid_window_attention_matches_jax(windows):
    pw = TINY_PWINDOW[windows]
    x = _x(24, (1, 2, 8, 12, 64))
    args = (64, pw["heads"], pw["dim_head"], pw["window_size"], True,
            pw["fusion_method"])
    _check_module(jv.PyramidWindowAttention(*args),
                  tv.PyramidWindowAttention(*args), (jnp.asarray(x),),
                  (torch.from_numpy(x),), 25, "PyramidWindowAttention")


@pytest.mark.parametrize("hetero", [True, False], ids=["hgt", "cav"])
def test_fusion_block_matches_jax(hetero):
    enc = tiny_v2xvit_encoder(3)
    cav = dict(enc["cav_att_config"], use_hetero=hetero)
    pw = enc["pwindow_att_config"]
    x, mask = _x(26), _mask()
    _, prior = _poses(4, 2, 4)
    types = prior[..., 2].astype(np.int32)
    _check_module(jv.V2XFusionBlock(1, cav, pw), tv.V2XFusionBlock(1, cav, pw),
                  (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(prior),
                   jnp.asarray(types)),
                  (torch.from_numpy(x), torch.from_numpy(mask),
                   torch.from_numpy(types)), 27, "V2XFusionBlock")


@pytest.mark.parametrize("windows", WINDOWS, ids=WIN_IDS)
def test_encoder_matches_jax(windows):
    """RTE with nonzero delays, the STTF warp and the ROI mask under
    non-identity poses, an absent agent, mixed types."""
    enc = tiny_v2xvit_encoder(windows)
    x = _x(28, (2, 4, 16, 24, 64))
    pt, prior = _poses(5, 2, 4)
    agent_mask = np.array([[True, True, True, True],
                           [True, True, False, True]])
    margin = _roi_margin((16, 24), pt, 0.4, 2)
    assert margin > ROI_MARGIN, f"an ROI sample lies {margin:.2e} from 0.5"
    jargs = tuple(map(jnp.asarray, (x, agent_mask, pt, prior)))
    targs = tuple(map(torch.from_numpy, (x, agent_mask, pt, prior)))
    got, want = _check_module(jv.V2XTEncoder(enc), tv.V2XTEncoder(enc), jargs,
                              targs, 29, "V2XTEncoder")
    assert np.isfinite(want).all()


# --- the tiny model --------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_run():
    """The tiny V2X-ViT det config, two scenes (one with a drone, one
    without) with perturbed poses and delays, seeded flax variables; JAX's
    outputs under each conv mode and dtype on demand."""
    hypes = tiny_v2xvit(jax_load_yaml(TINY))
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(0)
    scenes = [
        jax_make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                       lidar_range=hypes["preprocess"]["cav_lidar_range"],
                       pts_per_box=60, num_agents=na)[0]
        for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
                   {"vehicle": 2, "rsu": 1, "drone": 0})
    ]
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    perturb_poses(batch, np.random.default_rng(1))
    jmodels = {"f32": jax_build_model(hypes)}
    bf16 = copy.deepcopy(hypes)
    bf16["model"]["args"]["dtype"] = "bf16"
    jmodels["bf16"] = jax_build_model(bf16)
    # variables seed 31: the first from 23 up whose decoded boxes have no
    # pair within 1e-4 of the NMS threshold in either conv mode (23 had one
    # 9.1e-5 from it), which two packages' rounding could decide apart
    var = random_variables(jmodels["f32"], jnp_tree(batch), seed=31, train=False)
    cache = {}

    def jax_out(mode, dtype):
        if (mode, dtype) not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("AIRV2X_CONV_KERNEL", mode)  # read at trace time
                out = jax.jit(lambda v, b: jmodels[dtype].apply(
                    v, b, train=False))(var, jnp_tree(batch))
            cache[mode, dtype] = {k: np.asarray(v, np.float32)
                                  for k, v in out.items()}
        return cache[mode, dtype]

    return hypes, batch, var, jax_out


def _tiny_torch(var, seg=False, windows=3):
    hypes = tiny_v2xvit(load_yaml(TINY), windows)
    if seg:
        tiny_seg(hypes)
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    return model


def test_tiny_scene_exercises_the_warp(tiny_run):
    hypes, batch, _, _ = tiny_run
    enc = hypes["model"]["args"]["transformer"]["encoder"]
    margin = _roi_margin((48, 48), batch["pairwise_t"], 0.4,
                         enc["sttf"]["downsample_rate"])
    assert margin > ROI_MARGIN, f"an ROI sample lies {margin:.2e} from 0.5"
    assert (batch["prior_encoding"][:, 1:, 1] > 0).any()
    roi = np.asarray(jwarp.rotated_roi_mask(
        (48, 48), jnp.asarray(batch["pairwise_t"]), 0.4, 2))
    assert 0 < (~roi[:, 1:]).mean() < 0.5


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_det_model_matches_jax(tiny_run, monkeypatch, mode):
    _, batch, var, jax_out = tiny_run
    want = jax_out(mode, "f32")
    tmodel = _tiny_torch(var)
    assert isinstance(tmodel, Airv2xV2XViT)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    assert kernels.LAUNCHES["conv3x3"] == 0  # the CPU runs the plain version
    for k in ("psm", "rm", "obj"):
        assert got[k].shape == want[k].shape
        assert want[k].shape[:3] == (2, 48, 48)
        assert np.abs(want[k]).max() > 0
        assert_close(got[k].numpy(), want[k], TOL_MODEL, TOL_MODEL, k)
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0


def test_tiny_det_stages_compose(tiny_run):
    """encode -> backbone -> fuse -> heads is ``forward``."""
    _, batch, var, _ = tiny_run
    tmodel = _tiny_torch(var)
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        feats = tmodel.backbone(tmodel.encode(tb))
        fused = tmodel.fuse(feats, tb)
        staged = tmodel.heads(fused)
        whole = tmodel(tb)
    assert feats.shape == (2, 4, 64, 48, 48) and fused.shape == (2, 64, 48, 48)
    for k in ("psm", "rm", "obj"):
        torch.testing.assert_close(staged[k], whole[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_det_keep_sets_match_jax(tiny_run, mode):
    hypes, _, var, jax_out = tiny_run
    want = jax_out(mode, "f32")
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], np.float32)
    kw = dict(num_class=hypes["num_class"],
              obj_threshold=hypes["postprocess"]["target_args"]["obj_threshold"],
              nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=TOP_K)
    n = anchors.size // 7
    tmodel = _tiny_torch(var)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIRV2X_CONV_KERNEL", mode)
        with torch.no_grad():
            got = tmodel(batch_to_torch(tiny_run[1], "cpu"))
    for b in range(2):
        jdet = jax_decode(jnp.asarray(want["psm"][b]), jnp.asarray(want["rm"][b]),
                          jnp.asarray(want["obj"][b]), jnp.asarray(anchors),
                          jnp.eye(4), jnp.asarray(lr), **kw)
        tdet = decode_detections(got["psm"][b], got["rm"][b], got["obj"][b],
                                 torch.from_numpy(anchors), torch.eye(4),
                                 torch.from_numpy(lr), **kw)
        # the keep sets per anchor: the pool order may swap scores that tie
        # to within the two frameworks' rounding
        keep = {name: np.zeros(n, bool) for name in ("jax", "torch")}
        objness = jax.nn.sigmoid(jnp.asarray(want["obj"][b])).reshape(-1)
        gated = jnp.where(objness > kw["obj_threshold"], objness, -jnp.inf)
        keep["jax"][np.asarray(jax.lax.top_k(gated, 2 * TOP_K)[1])] = jdet.mask
        objness = torch.sigmoid(got["obj"][b]).reshape(-1)
        gated = torch.where(objness > kw["obj_threshold"], objness, -torch.inf)
        idx = torch.sort(gated, descending=True, stable=True)[1][:2 * TOP_K]
        keep["torch"][idx.numpy()] = tdet.mask.numpy()
        live = tdet.corners[:, :4, :2].contiguous()
        iou = quad_iou_plain(live, live).numpy()
        gap = np.abs(iou[np.triu_indices(len(iou), k=1)] - kw["nms_thresh"]).min()
        assert gap > 1e-4, f"an IoU lies {gap:.2e} from the NMS threshold"
        np.testing.assert_array_equal(keep["torch"], keep["jax"])
        assert 0 < keep["jax"].sum() < TOP_K


def test_tiny_naive_two_window_model_matches_jax():
    """The zoo's own tiny variant: two windows, naive mean."""
    hypes = tiny_v2xvit(jax_load_yaml(TINY), windows=2)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(6), layout, num_objects=6,
                          points_per_agent=1024, pts_per_box=60,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"])
    batch = {k: v[None] for k, v in b.items()}
    perturb_poses(batch, np.random.default_rng(7))
    margin = _roi_margin((48, 48), batch["pairwise_t"], 0.4, 2)
    assert margin > ROI_MARGIN, f"an ROI sample lies {margin:.2e} from 0.5"
    jmodel = jax_build_model(hypes)
    var = random_variables(jmodel, jnp_tree(batch), seed=31, train=False)
    want = jax.jit(lambda v, bb: jmodel.apply(v, bb, train=False))(
        var, jnp_tree(batch))
    tmodel = _tiny_torch(var, windows=2)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        assert_close(got[k].numpy(), np.asarray(want[k]), TOL_MODEL, TOL_MODEL, k)


@pytest.fixture(scope="module")
def tiny_seg_run(tiny_run):
    hypes = tiny_seg(tiny_v2xvit(jax_load_yaml(TINY)))
    jmodel = jax_build_model(hypes)
    batch = tiny_run[1]
    var = random_variables(jmodel, jnp_tree(batch), seed=24, train=False)
    return jmodel, var, batch


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_seg_model_matches_jax(tiny_seg_run, monkeypatch, mode):
    jmodel, var, batch = tiny_seg_run
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        var, jnp_tree(batch))
    tmodel = _tiny_torch(var, seg=True)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    assert set(got) == {"dynamic_seg", "static_seg", "comm_rate"}
    for k in ("dynamic_seg", "static_seg"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (2, 96, 96, w.shape[-1])
        assert_close(got[k].numpy(), w, TOL_MODEL * (1 + np.abs(w).max()), 0, k)
    dyn, sta = decode_segmentation(got["dynamic_seg"], got["static_seg"])
    jdyn, jsta = jax_decode_seg(want["dynamic_seg"], want["static_seg"])
    # the class maps agree wherever the top two classes are apart
    for g, w, logits in ((dyn, jdyn, want["dynamic_seg"]),
                         (sta, jsta, want["static_seg"])):
        top2 = np.sort(np.asarray(jax.nn.sigmoid(logits)), -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(g.numpy()[clear], np.asarray(w)[clear])


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_det_bf16_matches_jax_bf16(tiny_run, monkeypatch, mode):
    """The serving model cast to bf16 (``cast_weights_``) against the JAX
    package computing in bf16 over f32 parameters: within BF16_TOL of it,
    and no further from the exact (f32) outputs than JAX's own bf16 lies
    from them, with 50% room."""
    _, batch, var, jax_out = tiny_run
    want, exact = jax_out(mode, "bf16"), jax_out(mode, "f32")
    tmodel = cast_weights_(_tiny_torch(var), torch.bfloat16)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        g = got[k].float().numpy()
        scale = np.abs(want[k]).max()
        assert scale > 1
        err = np.abs(g - want[k]).max()
        assert err <= BF16_TOL * (1 + scale), (k, err, scale)
        own = np.abs(g - exact[k]).max()
        ref = np.abs(want[k] - exact[k]).max()
        assert own <= 1.5 * ref, (k, own, ref)


def test_transformer_op_count_matches_the_executed_linears(tiny_run):
    """``chip_smoke.transformer_ops`` (phase 11's floor): its executed Linear
    operations equal those forward hooks count on a run of the tiny model
    (two scenes, one agent absent, perturbed poses), and the work the
    function needs lies below the executed work in every part that computes
    both types or every slot."""
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes, batch, _, _ = tiny_run
    enc = hypes["model"]["args"]["transformer"]["encoder"]
    model = init_random_(build_model(tiny_v2xvit(load_yaml(TINY)),
                                     device="cpu"), seed=3).eval()
    tb = batch_to_torch(batch, "cpu")
    linear_ops = {}

    def hook(part):
        def count(m, args, out):
            linear_ops[part] = linear_ops.get(part, 0) + 2 * out.numel() * m.in_features
        return count

    handles = [
        m.register_forward_hook(hook(
            "RTE Linear" if ".rte." in n else "HGT Linear" if ".att." in n
            else "window pyramid Linear" if ".pwin." in n else "FFN Linear"))
        for n, m in model.fusion_net.named_modules()
        if isinstance(m, torch.nn.Linear)]
    try:
        with torch.inference_mode():
            feats = model.backbone(model.encode(tb))
            model.fuse(feats, tb)
    finally:
        for h in handles:
            h.remove()
    hw = tuple(feats.shape[-2:])
    ops = load_chip_smoke()
    executed = ops.transformer_ops(enc, tb, hw, needed=False)
    needed = ops.transformer_ops(enc, tb, hw, needed=True)
    assert {k: v for k, v in executed.items() if "Linear" in k} == linear_ops
    assert executed.keys() == needed.keys()
    for part in executed:
        assert 0 < needed[part] < executed[part], (part, needed, executed)
