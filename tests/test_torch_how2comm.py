"""How2comm in the PyTorch port against the JAX package on the CPU, f32.

Module by module through the weight bridge (seeded numpy inputs, seeded
flax variables, 1e-5 x (1 + scale)): the gaussian kernels and smoothings,
``flow_warp_border``, ``ReduceInfTC`` (with its transposed convs),
``FlowBackbone``, ``FlowGenerator`` (estimates and offset loss),
``MutualCommunication`` (sparse maps, masks, rate, DeepInfoMax loss, at a
threshold that cuts the maps, set in a gap of the gate's values more than
2e-4 wide), ``confidence_maps``, ``Decoupling``, ``TemporalAttention`` (an absent
slot's frame masked), ``LateFusion`` and ``STCFormer``. Then the tiny
``point_pillar_how2comm`` (the flat family's tiny config on its ResNet
backbone, 3 slots, T = 2 frames drawn apart with perturbed history and
poses by ``chip_smoke.py:scope_scene``, the third slot absent): psm / rm,
the losses and the rate at 1e-4 x (1 + scale), the NMS asserted more than
1e-4 from its decisions, the keep set, the history's effect, and an absent
slot's points without effect. Last, the tiny model on a loaded OPV2V
temporal batch (tests/test_torch_opv2v_data.py's fixture): both packages
fail on the batch as the datasets give it, and agree once its
``pairwise_t_full`` is repeated over the frames (``pairwise_over_frames``,
SCOPE's bridge: How2comm reads the current frame's, ``[:, -1]``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.fusion import how2comm as jh
from airv2x_tpu.models.fusion import stcformer as js
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.fusion import how2comm as th
from airv2x_tpu_torch.models.fusion import stcformer as ts
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_coalign import NMS_MARGIN, TOP_K, keep_sets
from tests.test_torch_opv2v_data import root, scope_batch  # noqa: F401
from tests.test_torch_point_pillar_family import RANGE
from tests.test_torch_point_pillar_family import tiny_hypes as flat_hypes
from tests.torch_port_helpers import CHIP_SMOKE, one_torch_thread, random_variables  # noqa: F401

MODULE_TOL = 1e-5
TOL = 1e-4
MARGIN = 1e-4


def _close(got, want, tol=MODULE_TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (1 + np.abs(want).max()), err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(module, var):
    load_flax_variables(module, var)
    return module.eval()


def _rng(seed):
    return np.random.default_rng(seed)


def test_gaussian_kernels_and_smoothing_match_jax():
    for k, s in ((5, 1.0), (3, 0.7)):
        np.testing.assert_array_equal(th.gaussian_kernel_2d(k, s),
                                      jh.gaussian_kernel_2d(k, s))
        np.testing.assert_array_equal(th.gaussian_kernel_1d(k, s),
                                      jh.gaussian_kernel_1d(k, s))
    x = _rng(0).uniform(size=(2, 3, 10, 12, 1)).astype(np.float32)
    v = _rng(1).uniform(size=(2, 3, 1, 1, 16)).astype(np.float32)
    _close(th.gaussian_smooth_2d(_t(x), 5, 1.0),
           jh.gaussian_smooth_2d(jnp.asarray(x), jh.gaussian_kernel_2d(5, 1.0)))
    _close(th.gaussian_smooth_channels(_t(v), 5, 1.0),
           jh.gaussian_smooth_channels(jnp.asarray(v),
                                       jh.gaussian_kernel_1d(5, 1.0)))


def test_flow_warp_border_matches_jax():
    rng = _rng(2)
    feats = rng.normal(size=(2, 3, 9, 11, 4)).astype(np.float32)
    flow = rng.normal(0, 3.0, (2, 3, 9, 11, 2)).astype(np.float32)
    flow[0, 0, 0, 0] = [-40.0, 50.0]  # clamped to the border
    _close(th.flow_warp_border(_t(feats), _t(flow)),
           jh.flow_warp_border(jnp.asarray(feats), jnp.asarray(flow)))


@pytest.mark.parametrize("hw", [(64, 64), (40, 72)])
def test_reduce_inf_tc_matches_jax(hw):
    x = _rng(3).normal(size=(2,) + hw + (8,)).astype(np.float32)
    jm = jh.ReduceInfTC(32)
    var = random_variables(jm, jnp.asarray(x), seed=4, train=False)
    off, scale = jm.apply(var, jnp.asarray(x), train=False)
    got = _port(th.ReduceInfTC(8, 32), var)(_t(x))
    assert off.shape == (2,) + hw + (2,)
    _close(got[0], off, what="offset")
    _close(got[1], scale, what="scale")


BACKBONE = {"layer_nums": [1, 2], "layer_strides": [2, 2], "num_filters": [16, 32],
            "upsample_strides": [1, 2], "num_upsample_filter": [24, 24]}


def test_flow_backbone_matches_jax():
    x = _rng(5).normal(size=(2, 32, 32, 12)).astype(np.float32)
    bb = BACKBONE
    jm = jh.FlowBackbone(bb["layer_nums"], bb["layer_strides"], bb["num_filters"],
                         bb["upsample_strides"], bb["num_upsample_filter"])
    var = random_variables(jm, jnp.asarray(x), seed=6, train=False)
    want = jm.apply(var, jnp.asarray(x), train=False)
    m = _port(th.FlowBackbone(12, bb["layer_nums"], bb["layer_strides"],
                              bb["num_filters"], bb["upsample_strides"],
                              bb["num_upsample_filter"]), var)
    got = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == (2, 32, 32, 8)
    _close(got, want)


@pytest.fixture(scope="module")
def slots():
    """(B, L, H, W, C) current and history maps, the second sample's third
    slot absent."""
    rng = _rng(7)
    cur = np.maximum(rng.normal(size=(2, 3, 32, 32, 6)), 0).astype(np.float32)
    hist = np.maximum(rng.normal(size=(2, 3, 32, 32, 6)), 0).astype(np.float32)
    mask = np.array([[True, True, True], [True, True, False]])
    cur[1, 2] = hist[1, 2] = 0.0
    return cur, hist, mask


def test_flow_generator_matches_jax(slots):
    cur, hist, mask = slots
    jm = jh.FlowGenerator(backbone_cfg=BACKBONE, channel=6)
    args = tuple(map(jnp.asarray, (cur, hist, mask)))
    var = random_variables(jm, *args, seed=8, train=False)
    est, loss = jm.apply(var, *args, train=False)
    got_est, got_loss = _port(th.FlowGenerator(BACKBONE, 6), var)(
        *map(_t, (cur, hist, mask)))
    _close(got_est, est, what="estimates")
    _close(got_loss, loss, what="offset loss")
    assert float(loss) > 0 and not got_est[1, 2].any()


@pytest.mark.parametrize("request_flag", [True, False])
def test_mutual_communication_matches_jax(slots, request_flag):
    """At a threshold set in the widest gap of the gate's values between
    their 30% and 70% quantiles (8 x 8 maps, so the gap is wide), so that
    the masks cut the maps and no decision lies within MARGIN of it."""
    cur, _, mask = slots
    cur = np.ascontiguousarray(cur[:, :, :8, :8])
    jm = jh.MutualCommunication(in_planes=6, thre=0.0, request_flag=request_flag,
                                ratio=2)
    var = random_variables(jm, jnp.asarray(cur), jnp.asarray(mask), seed=9,
                           train=False)
    m = _port(th.MutualCommunication(6, 0.0, request_flag=request_flag,
                                     ratio=2), var)
    with torch.no_grad():
        vals = np.sort(_sparse_matrix(m, _t(cur))[mask[:, 1:]].numpy().ravel())
    band = vals[int(0.3 * len(vals)):int(0.7 * len(vals))]
    i = int(np.argmax(np.diff(band)))
    thre = float((band[i] + band[i + 1]) / 2)
    assert (band[i + 1] - band[i]) / 2 > MARGIN
    jm = jh.MutualCommunication(in_planes=6, thre=thre, request_flag=request_flag,
                                ratio=2)
    sparse, loss, rate, masks = jm.apply(var, jnp.asarray(cur), jnp.asarray(mask),
                                         train=False)
    m.thre = thre
    got = m(_t(cur), _t(mask))
    _close(got[0], sparse, what="sparse")
    _close(got[1], loss, what="commu_loss")
    _close(got[2], rate, what="comm_rate")
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(masks))
    assert 0.2 < float(rate) < 0.8, float(rate)
    assert float(loss) != 0.0


def _sparse_matrix(m, feats):
    """The port module's pre-threshold sparse matrix (its forward's first
    half), to measure the threshold margin."""
    b, l, h, w, c = feats.shape
    flat = feats.reshape(b * l, h, w, c)

    def mlp(v):
        return th.conv_cl(m.ch_mlp_1, torch.relu(th.conv_cl(m.ch_mlp_0, v)))

    ch = torch.sigmoid(mlp(flat.mean((1, 2), keepdim=True))
                       + mlp(flat.amax((1, 2), keepdim=True))).reshape(b, l, 1, 1, c)
    sp = torch.sigmoid(th.conv_cl(m.spatial_request, torch.cat(
        [flat.mean(-1, keepdim=True), flat.amax(-1, keepdim=True)], -1))
    ).reshape(b, l, h, w, 1)
    act = th.gaussian_smooth_2d(torch.sigmoid(feats.mean(-1, keepdim=True)), 5, 1.0)
    if m.request_flag:
        chc = th.conv_cl(m.channel_fusion, torch.cat(
            [(1 - ch[:, :1]).expand_as(ch[:, 1:]), ch[:, 1:]], -1).reshape(
            b * (l - 1), 1, 1, 2 * c)).reshape(b, l - 1, 1, 1, c)
        spc = th.conv_cl(m.spatial_fusion, torch.cat(
            [(1 - sp[:, :1]).expand_as(sp[:, 1:]), sp[:, 1:]], -1).reshape(
            b * (l - 1), h, w, 2)).reshape(b, l - 1, h, w, 1)
    else:
        chc, spc = ch[:, 1:], sp[:, 1:]
    chc = th.gaussian_smooth_channels(torch.sigmoid(chc), 5, 1.0)
    spc = th.gaussian_smooth_2d(torch.sigmoid(spc), 5, 1.0)
    return chc * spc * act[:, 1:]


def test_confidence_maps_match_jax():
    psm = _rng(10).normal(size=(2, 3, 12, 14, 2)).astype(np.float32)
    _close(th.confidence_maps(_t(psm)), jh.confidence_maps(jnp.asarray(psm)))


def test_decoupling_matches_jax(slots):
    cur, _, _ = slots
    conf = _rng(11).uniform(size=cur.shape[:4] + (1,)).astype(np.float32)
    want = js.Decoupling().apply({}, jnp.asarray(cur), jnp.asarray(conf))
    got = ts.Decoupling()(_t(cur), _t(conf))
    for g, w in zip(got, want):
        _close(g, w)


def test_temporal_attention_matches_jax(slots):
    cur, hist, mask = slots
    seq = np.concatenate([cur[:, :1], hist], axis=1)
    fmask = np.concatenate([np.ones((2, 1), bool), mask], axis=1)
    jm = js.TemporalAttention(6)
    var = random_variables(jm, jnp.asarray(seq), jnp.asarray(fmask), seed=12)
    want = jm.apply(var, jnp.asarray(seq), jnp.asarray(fmask))
    got = _port(ts.TemporalAttention(6), var)(_t(seq), _t(fmask))
    _close(got, want)
    # the masked frame does not enter: moving it moves nothing
    moved = seq.copy()
    moved[1, 3] += 5.0
    again = _port(ts.TemporalAttention(6), var)(_t(moved), _t(fmask))
    assert torch.equal(again[1], got[1])


def test_late_fusion_matches_jax(slots):
    cur, hist, _ = slots
    a, b = cur[:, 0], hist[:, 1]
    jm = js.LateFusion()
    var = random_variables(jm, jnp.asarray(a), jnp.asarray(b), seed=13)
    _close(_port(ts.LateFusion(6), var)(_t(a), _t(b)),
           jm.apply(var, jnp.asarray(a), jnp.asarray(b)))


def _query_margin(scores, k):
    """The smallest gap between the K-th and (K+1)-th query score of a
    deformable refinement, over the largest |score|."""
    s = np.sort(np.asarray(scores).reshape(scores.shape[0], -1), axis=1)[:, ::-1]
    return float(((s[:, k - 1] - s[:, k]) / np.abs(s).max(1)).min())


@pytest.mark.parametrize("level", [0, 1])
def test_stcformer_matches_jax(slots, level):
    cur, hist, mask = slots
    s = 2 ** level
    feat, his = cur[:, :, ::s, ::s], hist[:, :, ::s, ::s]
    # seed 15: the first from 14 up whose query cuts clear MARGIN
    conf = _rng(15).uniform(size=cur.shape[:4] + (1,)).astype(np.float32)
    conf[1, 2] = 0.0
    nq = 40
    jm = js.STCFormer(channels=6, level=level, num_queries=nq, max_cav=3)
    args = tuple(map(jnp.asarray, (feat, conf, his, mask)))
    var = random_variables(jm, *args, seed=15, train=False)
    want, wbranches = jm.apply(var, *args, train=False)
    m = _port(ts.STCFormer(6, level, num_queries=nq, max_cav=3), var)
    got, branches = m(*map(_t, (feat, conf, his, mask)))
    _close(got, want)
    for g, w in zip(branches, wbranches):
        _close(g, w)
    _, _, exc_map, com_map = js.Decoupling().apply({}, jnp.asarray(feat),
                                                   jnp.asarray(conf[:, :, ::s, ::s]))
    for cm in (exc_map, com_map):
        assert _query_margin(np.asarray(cm).sum(1), nq) > MARGIN


# ---------------------------------------------------------------------------
# the tiny model
# ---------------------------------------------------------------------------

FUSION_ARGS = {"voxel_size": [0.4, 0.4, 4], "downsample_rate": 1,
               "communication": {"thre": 0.01, "request_flag": True,
                                 "gaussian_smooth": {"k_size": 5, "c_sigma": 1.0}},
               "communication_flag": True, "num_queries": 32 * 32,
               "layer_nums": [1, 1], "num_filters": [16, 32]}
FORWARD_SEED = 5


def how2comm_hypes():
    """The flat family's tiny config as How2comm on its ResNet backbone,
    with ``fusion_args`` at the tiny widths. Its query budget covers every
    cell of every level, so no query cut decides the outputs (the random
    weights' saturated confidences nearly tie; the cut is held in
    ``test_stcformer_matches_jax``)."""
    h = flat_hypes("point_pillar")
    h["model"]["core_method"] = "point_pillar_how2comm"
    args = h["model"]["args"]
    args["base_bev_backbone"]["resnet"] = True
    args.update(flow_flag=True, delay=1, fusion_args=copy.deepcopy(FUSION_ARGS))
    return h


@pytest.fixture(scope="module")
def scene():
    b = CHIP_SMOKE.scope_scene(np.random.default_rng(0), SlotLayout(counts=(3, 0, 0)),
                               2, RANGE, pose_rng=np.random.default_rng(1),
                               points_per_agent=512)
    b["agent_mask"][0, :, 2] = False
    b["points_mask"][0, :, 2] = False
    return b


@pytest.fixture(scope="module")
def tiny_run(scene):
    hypes = how2comm_hypes()
    jmodel = jax_build_model(hypes)
    jb = jax.tree.map(jnp.asarray, scene)
    var = random_variables(jmodel, jb, seed=FORWARD_SEED, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(var, jb))
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    return hypes, model, want


def _run(model, batch, record=None):
    hooks = []
    if record is not None:
        hooks = [m.register_forward_hook(lambda mod, args, out: record.append(
            (mod.num_queries, args[1].detach().numpy().copy())))
            for m in model.modules()
            if type(m).__name__ == "DeformableQueryRefine"]
    try:
        with torch.no_grad():
            return model(batch_to_torch(batch, "cpu"))
    finally:
        for h in hooks:
            h.remove()


def test_tiny_how2comm_matches_jax(scene, tiny_run):
    hypes, model, want = tiny_run
    scores = []
    got = _run(model, scene, scores)
    assert set(got) == set(want)
    for k in ("psm", "rm"):
        assert got[k].shape == want[k].shape and want[k].shape[:3] == (1, 32, 32)
        _close(got[k], want[k], TOL, k)
    for k in ("offset_loss", "commu_loss", "comm_rate"):
        _close(got[k], want[k], TOL, k)
    assert float(want["offset_loss"]) > 0
    assert len(scores) == 4  # two branches per level
    assert all(nq >= s[0, 0].size for nq, s in scores)
    pairs, margin = keep_sets(hypes, want, got)
    assert margin > NMS_MARGIN, margin
    for jkeep, tkeep in pairs:
        np.testing.assert_array_equal(tkeep, jkeep)
        assert 0 < jkeep.sum() < TOP_K


def test_tiny_how2comm_history_and_absent_slot(scene, tiny_run):
    """The history frame moves the outputs; an absent slot's points, in
    either frame, do not."""
    _, model, _ = tiny_run
    base = _run(model, scene)
    hist = dict(scene, points=scene["points"].copy())
    hist["points"][0, 0, 1, :, :2] += 0.8
    assert not torch.equal(_run(model, hist)["psm"], base["psm"])
    absent = dict(scene, points=scene["points"].copy())
    absent["points"][0, :, 2, :, :2] *= 0.5
    assert torch.equal(_run(model, absent)["psm"], base["psm"])


def test_how2comm_on_a_loaded_temporal_batch(scope_batch):  # noqa: F811
    raw, fixed = scope_batch
    hypes = how2comm_hypes()
    hypes["model"]["args"]["max_cav"] = raw["agent_mask"].shape[-1]
    jmodel = jax_build_model(hypes)
    scene = {k: v for k, v in fixed.items() if k != "labels"}
    var = random_variables(jmodel, jax.tree.map(jnp.asarray, scene),
                           seed=FORWARD_SEED, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(var, jax.tree.map(
            jnp.asarray, scene)))
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    got = _run(model, scene)
    for k in ("psm", "rm", "offset_loss", "commu_loss"):
        _close(got[k], want[k], TOL, k)
    assert raw["points"].ndim == 5 and raw["pairwise_t_full"].ndim == 5
    bad = {k: v for k, v in raw.items() if k != "labels"}
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jax.eval_shape(lambda v, b: jmodel.apply(v, b, train=False), var,
                       jax.tree.map(jnp.asarray, bad))
    with pytest.raises(ValueError, match="pairwise_over_frames"):
        _run(model, bad)
