"""BM2CP in the PyTorch port against the JAX package on the CPU, f32: its
modules (``ImgCamEncode`` with the observed-depth one-hot, ``fuse_ego_depth``,
``MultiModalFusion`` with ``ImgModalFusion``, ``bm2cp_voxel_pooling``) and
the tiny models (``chip_smoke.py:tiny_bm2cp_hypes``): ``airv2x_bm2cp`` det
and seg over the tiny config's four slots (vehicle, vehicle, rsu, drone),
and the flat ``point_pillar_bm2cp`` with ``supervise_single`` and the
two-view (6-D) ego-composite depth maps, both on perturbed poses.

Each tiny scene asserts that every present odd slot's confidence lies more
than BM2CP_MARGIN from its threshold map, where the communication mask is
decided (variables seed 6 for the flat model: seed 5's lies 6e-7 from it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import bm2cp_airv2x_batch as jax_bm2cp_batch
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.fusion import bm2cp_flat as jflat
from airv2x_tpu.models.point_pillar_bm2cp_model import (
    bm2cp_voxel_pooling as jax_voxel_pooling)
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import (
    batch_to_torch, bm2cp_airv2x_batch, perturb_poses)
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion import bm2cp_flat
from airv2x_tpu_torch.models.point_pillar_bm2cp_model import bm2cp_voxel_pooling
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import (
    CHIP_SMOKE, TINY, assert_close, nhwc_to_nchw, one_torch_thread,
    random_variables)

MOD_TOL = 1e-4  # module outputs, x (1 + scale): a trunk's sums in another order
TOL = 1e-4  # whole-model outputs through the trunk and ~30 convs, x (1 + scale)
VAR_SEED = {"airv2x_bm2cp": 5, "point_pillar_bm2cp": 6}


def depth_levels(rng, shape, bins, observed=0.015):
    """A sparse projected LiDAR depth: -1 (unobserved) but on a share
    ``observed`` of the pixels, which hold levels in [0, bins)."""
    d = rng.integers(0, bins, shape).astype(np.float32)
    d[rng.uniform(size=shape) >= observed] = -1.0
    return d


@pytest.mark.parametrize("downsample", [8, 16])
def test_img_cam_encode_matches_jax(downsample):
    """Images of 64 x 96, six depth bins, context 16: the lifted features
    (B*, fH, fW, D, C), where the pooled observed depth replaces the
    softmax by its one-hot."""
    rng = np.random.default_rng(1)
    imgs = rng.normal(size=(3, 64, 96, 3)).astype(np.float32)
    depth = depth_levels(rng, (3, 64, 96), 6)
    jmod = jflat.ImgCamEncode(depth_bins=6, context_c=16, downsample=downsample)
    var = random_variables(jmod, jnp.asarray(imgs), jnp.asarray(depth), seed=2,
                           train=False)
    want = np.asarray(jax.jit(lambda v, i, d: jmod.apply(v, i, d, train=False))(
        var, jnp.asarray(imgs), jnp.asarray(depth)))
    mod = bm2cp_flat.ImgCamEncode(6, 16, downsample)
    load_flax_variables(mod, var)
    mod.eval()
    with torch.no_grad():
        got = mod(nhwc_to_nchw(imgs), torch.from_numpy(depth)).numpy()
    f = 64 // downsample
    assert got.shape == want.shape == (3, f, 96 // downsample, 6, 16)
    assert_close(got, want, MOD_TOL * (1 + np.abs(want).max()), 0, "lifted")
    pooled = bm2cp_flat.pool_observed_depth(torch.from_numpy(depth), f,
                                            96 // downsample)
    assert 0 < float((pooled > 0).float().mean()) < 1  # both kinds of pixel


def test_fuse_ego_depth_matches_jax_exactly():
    """(B, L, 2, H, W) self and ego views with unobserved pixels and an
    absent agent -> the per-agent maps, bit for bit."""
    rng = np.random.default_rng(3)
    maps = depth_levels(rng, (2, 3, 2, 8, 12), 6, observed=0.5)
    mask = np.array([[True, True, False], [True, True, True]])
    want = np.asarray(jflat.fuse_ego_depth(jnp.asarray(maps), jnp.asarray(mask)))
    got = bm2cp_flat.fuse_ego_depth(torch.from_numpy(maps), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want[:, 0], maps[:, 0, 0])  # the ego was filled


def test_multimodal_fusion_matches_jax():
    """Camera and pillar volumes (B 2, Z 2, 6 x 8, C 16), each empty in its
    own cells, so all four routes occur: the fused map, the threshold map
    and the mask code."""
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 2, 6, 8, 16)).astype(np.float32)
    pc = rng.normal(size=(2, 2, 6, 8, 16)).astype(np.float32)
    img[rng.uniform(size=img.shape[:4]) < 0.3] = 0.0
    pc[rng.uniform(size=pc.shape[:4]) < 0.4] = 0.0
    jmod = jflat.MultiModalFusion(dim=16)
    var = random_variables(jmod, jnp.asarray(img), jnp.asarray(pc), seed=5)
    want = [np.asarray(w) for w in jmod.apply(var, jnp.asarray(img),
                                              jnp.asarray(pc))]
    mod = bm2cp_flat.MultiModalFusion(16)
    load_flax_variables(mod, var)
    with torch.no_grad():
        got = [g.numpy() for g in mod(torch.from_numpy(img), torch.from_numpy(pc))]
    assert_close(got[0], want[0], MOD_TOL * (1 + np.abs(want[0]).max()), 0, "fused")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert set(np.unique(want[2])) == {1.0, 2.0, 3.0, 4.0}


def test_voxel_pooling_matches_jax():
    """Points over the grid and a margin around it (some within one cell
    below the low corner, which truncate into cell 0), Z kept (3 levels):
    the (B, Z, Y, X, C) sums."""
    rng = np.random.default_rng(5)
    geom = rng.uniform(-7.0, 7.0, (2, 3, 5, 7, 3)).astype(np.float32)
    geom[..., 2] = rng.uniform(-4.0, 3.0, geom.shape[:-1])
    feats = rng.normal(size=(2, 3, 5, 7, 4)).astype(np.float32)
    dx = np.array([0.4, 0.4, 2.0], np.float32)
    bx = np.array([-6.2, -6.2, -2.0], np.float32)
    nx = np.array([32, 32, 3])
    want = np.asarray(jax_voxel_pooling(jnp.asarray(geom), jnp.asarray(feats),
                                        jnp.asarray(dx), jnp.asarray(bx), nx))
    got = bm2cp_voxel_pooling(torch.from_numpy(geom), torch.from_numpy(feats),
                              torch.from_numpy(dx), torch.from_numpy(bx - dx / 2),
                              nx)
    assert got.shape == want.shape == (2, 3, 32, 32, 4)
    assert_close(got.numpy(), want, 1e-6, 1e-6, "pooled")
    low = (geom[..., 0] < -6.4) & (geom[..., 0] > -6.8)
    assert low.any()  # truncation toward zero, not floor, decides these


# --- the tiny models --------------------------------------------------------------


def tiny_scene(hypes, name):
    """A make_scene sample on the tiny config's four slots (seed 0, 800
    points per agent, poses perturbed by seed 2) with the tiny BM2CP camera
    blocks (the JAX package's ``bm2cp_airv2x_batch``, seed 1); for the flat
    model the vehicle block over all four slots, its depth maps the
    two-view (B, L, 2, Ncam, H, W) composite input."""
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(0), layout, num_objects=4,
                          points_per_agent=800, pts_per_box=40,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          num_agents={"vehicle": 2, "rsu": 1, "drone": 1})
    b = perturb_poses({k: v[None] for k, v in b.items()},
                      np.random.default_rng(2))
    cams = jax_bm2cp_batch(CHIP_SMOKE.tiny_bm2cp_hypes(hypes), np.random.default_rng(1))
    if name == "airv2x_bm2cp":
        b.update({k: v for k, v in cams.items() if k.startswith("cam_")})
        return b
    veh = cams["cam_vehicle"]
    cam = {k: np.concatenate([v[:, :2], v[:, 2:3], v[:, 2:3]], axis=1)
           for k, v in veh.items()}
    rng = np.random.default_rng(7)
    dm = cam["depth_maps"]
    cam["depth_maps"] = np.stack([dm, depth_levels(rng, dm.shape, 6, 0.3)],
                                 axis=2)
    b["cam_vehicle"] = cam
    b["agent_mask"][0, 3] = False
    b["points_mask"][0, 3] = False
    return b


CASES = {"airv2x_bm2cp-det": ("airv2x_bm2cp", "det"),
         "airv2x_bm2cp-seg": ("airv2x_bm2cp", "seg"),
         "point_pillar_bm2cp": ("point_pillar_bm2cp", "det")}


@pytest.fixture(scope="module", params=sorted(CASES))
def tiny_run(request):
    name, task = CASES[request.param]
    jh = CHIP_SMOKE.tiny_bm2cp_hypes(jax_load_yaml(TINY), name, task)
    th = CHIP_SMOKE.tiny_bm2cp_hypes(load_yaml(TINY), name, task)
    batch = tiny_scene(jh, name)
    jmodel = jax_build_model(jh)
    jb = jax.tree.map(jnp.asarray, batch)
    var = random_variables(jmodel, jb, seed=VAR_SEED[name], train=False)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(var, jb)
    model = build_model(th, device="cpu")
    load_flax_variables(model, var)
    tb = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        got = model(tb)
    return dict(name=name, task=task, model=model, batch=tb,
                want=jax.tree.map(np.asarray, want), got=got)


def test_tiny_model_matches_jax(tiny_run):
    want, got = tiny_run["want"], tiny_run["got"]
    assert set(got) == set(want)
    heads = {"det": ("psm", "rm", "obj"), "seg": ("dynamic_seg", "static_seg")}
    keys = ((("psm", "rm", "psm_single_v", "rm_single_v", "psm_single_i",
              "rm_single_i")) if tiny_run["name"] == "point_pillar_bm2cp"
            else heads[tiny_run["task"]])
    for k in keys:
        w = want[k]
        assert np.abs(w).max() > 0, k
        assert_close(got[k].numpy(), w, TOL * (1 + np.abs(w).max()), 0, k)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    assert set(np.unique(want["mask"])) >= {2.0, 3.0}  # LiDAR-only, camera-only
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                    abs=1e-6)


def test_tiny_model_comm_mask_is_decided_clearly(tiny_run):
    margin = CHIP_SMOKE.bm2cp_comm_margin(tiny_run["model"], tiny_run["batch"])
    assert margin > CHIP_SMOKE.BM2CP_MARGIN, margin


def test_port_synthetic_bm2cp_batch_is_jax_s():
    hypes = CHIP_SMOKE.tiny_bm2cp_hypes(jax_load_yaml(TINY))
    want = jax_bm2cp_batch(hypes, np.random.default_rng(9), batch_size=2)
    got = bm2cp_airv2x_batch(hypes, np.random.default_rng(9), batch_size=2)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
