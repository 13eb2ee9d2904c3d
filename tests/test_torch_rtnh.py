"""RTNH of the port against the JAX package on the CPU:

  * ``models/sparse3d.py`` module by module through the weight bridge, f32,
    within 1e-4 x (1 + scale): the mask dilation, ``SparseConv3d`` (strided
    and the (z_k, 1, 1) collapse) and ``SubMConv3d`` on a sparse mask,
    ``SparseBN`` in eval and train mode (its statistics over the active
    sites, torch's eps 1e-5 and momentum 0.1), and ``TorchDeconv2d`` at the
    three kernel / stride / padding triples RTNH builds (3/1/1, 6/2/2,
    12/4/4), whose bridged kernel is flipped and transposed;
  * the tiny ``RTNHIntermediate`` (the RTNH YAML on a 64 x 32 x 8 grid, 8 to
    16 channels, 3 slots, one absent) on a radar cloud and, as on the
    synthetic batches that carry none (ROADMAP §3), on the LiDAR cloud:
    psm / rm, comm_rate and the keep sets of the decode;
  * one train step against JAX's f32 ``make_train_step`` (its float64
    step fails inside the JAX package: ``dilate_mask_3d`` reduces an f32
    mask from a float64 initial value): the loss parts, every gradient,
    the updated parameters and BN statistics.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airv2x_tpu.models.sparse3d as jsp
from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models import sparse3d as tsp
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_coalign import keep_sets
from tests.test_torch_v2xr_models import nms_decision_margin, NMS_MARGIN
from tests.torch_port_helpers import (
    REPO, assert_close, one_torch_thread, random_variables)  # noqa: F401
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    port_step, twin)

TOL = 1e-4
YAML = os.path.join(REPO, "hypes_yaml/V2X-R/4DRadar/V2XR_RTNH.yaml")
RANGE = [-12.8, -6.4, -3, 12.8, 6.4, 1]  # 64 x 32 x 8 cells at 0.4 / 0.4 / 0.5
BACKBONE = {"ENCODING": {"CHANNEL": [8, 16, 16]},
            "TO_BEV": {"CHANNEL": [8, 8, 8]}}
# variables seed: the first from 3 whose decode keeps boxes on both clouds
# with every NMS decision more than 1e-3 from the threshold (seed 3's lies
# 5.9e-5 from it)
SEED = 11


def rtnh_hypes(load):
    h = load(YAML)
    h["preprocess"]["cav_lidar_range"] = list(RANGE)
    h["preprocess"]["args"]["max_voxel_train"] = 600
    h["postprocess"]["anchor_args"].update(cav_lidar_range=list(RANGE), W=64,
                                           H=32)
    h["postprocess"]["max_num"] = 20
    args = h["model"]["args"]
    args.update(max_cav=3, BACKBONE=copy.deepcopy(BACKBONE),
                PRE_PROCESSOR={"OUT_DIM": 8})
    h["train_params"]["max_cav"] = 3
    return h


def _nc(a):  # NDHWC -> NCDHW
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _cl(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


def _grid(rng, shape=(2, 6, 10, 12), c=4, p=0.15):
    mask = rng.uniform(size=shape) < p
    x = rng.normal(0, 1, shape + (c,)).astype(np.float32) * mask[..., None]
    return x, mask


@pytest.mark.parametrize("k,s,p", [((3, 3, 3), 2, 1), ((1, 1, 1), 1, 0),
                                   ((3, 1, 1), 1, 0)])
def test_dilate_mask_matches_jax(k, s, p):
    _, mask = _grid(np.random.default_rng(0))
    want = np.asarray(jsp.dilate_mask_3d(jnp.asarray(mask), k, (s,) * 3, (p,) * 3))
    got = tsp.dilate_mask_3d(torch.from_numpy(mask), k, s, p).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= mask.sum() * (k == (1, 1, 1))


@pytest.mark.parametrize("kind", ["sparse_s2", "sparse_tobev", "subm"])
def test_sparse_convs_match_jax(kind):
    x, mask = _grid(np.random.default_rng(1))
    if kind == "sparse_s2":
        jm = jsp.SparseConv3d(8, stride=(2, 2, 2), padding=(1, 1, 1))
        tm = tsp.SparseConv3d(4, 8, stride=2, padding=1)
    elif kind == "sparse_tobev":
        jm = jsp.SparseConv3d(8, kernel=(6, 1, 1))
        tm = tsp.SparseConv3d(4, 8, kernel=(6, 1, 1))
    else:
        jm, tm = jsp.SubMConv3d(8), tsp.SubMConv3d(4, 8)
    var = random_variables(jm, x, mask, seed=2)
    wy, wm = jm.apply(var, jnp.asarray(x), jnp.asarray(mask))
    load_flax_variables(tm, var)
    with torch.no_grad():
        ty, tmask = tm(_nc(x), torch.from_numpy(mask))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(wm))
    want = np.asarray(wy)
    assert_close(_cl(ty), want, atol=TOL * (1 + np.abs(want).max()), rtol=0)
    assert np.abs(want).max() > 0.1


@pytest.mark.parametrize("train", [False, True])
def test_sparse_bn_matches_jax(train):
    x, mask = _grid(np.random.default_rng(4), c=6)
    x = x * 3.0 + 1.5 * mask[..., None]  # statistics far from the defaults
    jm = jsp.SparseBN()
    var = random_variables(jm, x, mask, seed=5)
    res = jm.apply(var, jnp.asarray(x), jnp.asarray(mask), train,
                   mutable=["batch_stats"] if train else False)
    want, stats = res if train else (res, None)
    tm = tsp.SparseBN(6)
    load_flax_variables(tm, var)
    tm.train(train)
    with torch.no_grad():
        got = tm(_nc(x), torch.from_numpy(mask))
    want = np.asarray(want)
    assert_close(_cl(got), want, atol=TOL * (1 + np.abs(want).max()), rtol=0)
    assert (_cl(got)[~mask] == 0).all()
    assert tm.bn.eps == 1e-5 and tm.bn.flax_momentum == 0.9
    if train:
        bn = stats["batch_stats"]["MaskedBatchNorm_0"]
        for name in ("mean", "var"):
            assert_close(getattr(tm.bn, f"running_{name}").numpy(),
                         np.asarray(bn[name]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (6, 2, 2), (12, 4, 4)])
def test_deconv_orientation_matches_jax(k, s, p):
    """An asymmetric input through RTNH's transposed convs: output size
    (in - 1) s + k - 2 p and values within TOL (a kernel bridged without the
    flip, or transposed the wrong way, fails)."""
    x = np.random.default_rng(6).normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    jm = jsp.TorchDeconv2d(4, kernel=k, stride=s, padding=p)
    var = random_variables(jm, x, seed=7)
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = tsp.TorchDeconv2d(6, 4, k, s, p)
    load_flax_variables(tm, var)
    with torch.no_grad():
        got = tm(_nc(x))
    assert want.shape[1:3] == ((5 - 1) * s + k - 2 * p, (7 - 1) * s + k - 2 * p)
    assert_close(_cl(got), want, atol=TOL * (1 + np.abs(want).max()), rtol=0)


# --- the tiny model -------------------------------------------------------


@pytest.fixture(scope="module")
def batch():
    """Two labelled tiny scenes with radar clouds (test_torch_v2xr_models's
    batch recipe on RTNH's range), the second's third slot absent."""
    from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
    from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
    from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid

    h = rtnh_hypes(jax_load_yaml)
    anchors = generate_anchor_grid(h["postprocess"]["anchor_args"])
    b, _ = jax_make_batch(
        np.random.default_rng(3), JaxSlotLayout(counts=(3, 0, 0)), 2,
        anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=h["postprocess"]["target_args"], num_objects=4,
        points_per_agent=768, lidar_range=RANGE, max_boxes=20, pts_per_box=40,
        radar_points_per_agent=96)
    for k in ("agent_mask", "points_mask", "radar_points_mask"):
        b[k][1, 2] = False
    return b


def _scene(batch, radar=True):
    drop = {"labels"} | (set() if radar else {"radar_points", "radar_points_mask"})
    return {k: v for k, v in batch.items() if k not in drop}


@pytest.fixture(scope="module")
def jax_run(batch):
    """(hypes, flax variables, {radar: JAX eval outputs})."""
    h = rtnh_hypes(jax_load_yaml)
    model = jax_build_model(h)
    var = random_variables(model, jax.tree.map(jnp.asarray, _scene(batch)),
                           seed=SEED, train=False)
    fwd = jax.jit(lambda v, b: model.apply(v, b, train=False))
    outs = {r: jax.tree.map(np.asarray, fwd(var, jax.tree.map(
        jnp.asarray, _scene(batch, r)))) for r in (True, False)}
    return h, var, outs


@pytest.mark.parametrize("radar", [True, False], ids=["radar", "lidar"])
def test_rtnh_forward_matches_jax(batch, jax_run, radar):
    _, var, outs = jax_run
    th = rtnh_hypes(load_yaml)
    model = build_model(th, device="cpu")
    load_flax_variables(model, var)
    assert model.grid == (64, 32, 8)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch, radar), "cpu"))
    want = outs[radar]
    for k in ("psm", "rm"):
        assert got[k].shape == want[k].shape == (2, 16, 32, 2 * (7 if k == "rm" else 1))
        assert_close(got[k].numpy(), want[k], atol=TOL * (1 + np.abs(want[k]).max()),
                     rtol=0, what=k)
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0
    assert nms_decision_margin(th, got) > NMS_MARGIN
    pairs, _ = keep_sets(th, want, got)
    for jkeep, tkeep in pairs:
        np.testing.assert_array_equal(tkeep, jkeep)
    assert sum(int(j.sum()) for j, _ in pairs) > 0
    # the two clouds give other maps: the batch's radar is what RTNH reads
    assert np.abs(outs[True]["psm"] - outs[False]["psm"]).max() > 1e-3


def test_rtnh_train_step_matches_jax(batch, jax_run):
    jh, var, _ = jax_run
    th = rtnh_hypes(load_yaml)
    params, stats, jparts, grads = jax_step(jh, batch, var)
    model, parts = port_step(th, batch, var)
    check_loss_parts(parts, jparts)
    check_gradients(model, twin(th, grads, stats))
    assert check_params_and_stats(model, twin(th, params, stats),
                                  twin(th, grads, stats), min_clear=100) > 0
