"""The classic voxel path of the PyTorch port against the JAX package on the
CPU: ``pillarize`` (exact, with pillar and point overflow and invalid
points), ``PillarVFE`` (eval and train mode, one and two PFN layers), the
pillar and voxel scatters, and both encoders' classic branches (the
heterogeneous encoder of the AirV2X models, the flat ``PointPillarBase``)
on the tiny configs with ``fast_pillars: false``, in f32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.pillar_vfe import PillarVFE as JaxPillarVFE
from airv2x_tpu.ops import scatter as jax_scatter
from airv2x_tpu.ops.voxelize import pillarize as jax_pillarize
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.pillar_vfe import PillarVFE
from airv2x_tpu_torch.ops import scatter
from airv2x_tpu_torch.ops.voxelize import pillarize, pillarize_batch
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_point_pillar_family import _hypes as flat_hypes
from tests.torch_port_helpers import (
    TINY, assert_close, jnp_tree, one_torch_thread, random_variables)

TOL = 1e-5  # the PFN and the scatter: a few f32 ops
ENC_TOL = 1e-5  # an encoder's BEV map, x (1 + scale)
RANGE = [-6.4, -6.4, -3.0, 6.4, 6.4, 1.0]
VOXEL = [0.4, 0.4, 4.0]
GRID = (32, 32, 1)


def cloud(seed, n=600, hot=True):
    """n points over RANGE and a margin around it (out of range), some
    padding rows, and (``hot``) 40 points in one cell."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, 0] = rng.uniform(-7.5, 7.5, n)
    pts[:, 1] = rng.uniform(-7.5, 7.5, n)
    pts[:, 2] = rng.uniform(-3.5, 1.5, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    if hot:
        pts[:40, :2] = rng.uniform(1.21, 1.59, (40, 2))
        pts[:40, 2] = rng.uniform(-2.0, 0.0, 40)
    mask = rng.uniform(size=n) > 0.1
    return pts, mask


def cell_margin(pts, mask):
    """The least distance of a valid point from a cell boundary (so that
    ``floor`` decides every cell the same in both packages)."""
    rel = (pts[:, :3] - np.asarray(RANGE[:3])) / np.asarray(VOXEL)
    frac = np.abs(rel - np.round(rel)) * np.asarray(VOXEL)
    return float(frac[mask].min())


@pytest.mark.parametrize("caps", [(2048, 64), (100, 64), (2048, 4), (60, 3)],
                         ids=["roomy", "pillar-overflow", "point-overflow",
                              "both-overflow"])
def test_pillarize_matches_jax_exactly(caps):
    pts, mask = cloud(1)
    assert cell_margin(pts, mask) > 1e-4
    kw = dict(grid_size=GRID, max_pillars=caps[0], max_points_per_pillar=caps[1])
    want = jax_pillarize(jnp.asarray(pts), jnp.asarray(mask),
                         lidar_range=jnp.asarray(RANGE, jnp.float32),
                         voxel_size=jnp.asarray(VOXEL, jnp.float32), **kw)
    got = pillarize(torch.from_numpy(pts), torch.from_numpy(mask),
                    lidar_range=RANGE, voxel_size=VOXEL, **kw)
    for name in ("voxels", "coords", "num_points", "mask"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    occupied = int(np.asarray(want.mask).sum())
    assert (occupied == caps[0]) == (caps[0] < 200)  # the pillar cap bites
    assert (int(np.asarray(want.num_points).max()) == caps[1]) == (caps[1] < 40)


def test_pillarize_batch_stacks_the_clouds():
    clouds = [cloud(s) for s in (2, 3)]
    pts = np.stack([c[0] for c in clouds])
    mask = np.stack([c[1] for c in clouds])
    kw = dict(lidar_range=RANGE, voxel_size=VOXEL, grid_size=GRID,
              max_pillars=300, max_points_per_pillar=8)
    got = pillarize_batch(torch.from_numpy(pts), torch.from_numpy(mask), **kw)
    for i in range(2):
        one = pillarize(torch.from_numpy(pts[i]), torch.from_numpy(mask[i]), **kw)
        for a, b in zip(got, one):
            assert torch.equal(a[i], b)


@pytest.fixture(scope="module")
def pillars():
    """Two clouds pillarized by JAX (caps 300 x 8)."""
    clouds = [cloud(s) for s in (4, 5)]
    out = [jax_pillarize(jnp.asarray(p), jnp.asarray(m),
                         lidar_range=jnp.asarray(RANGE, jnp.float32),
                         voxel_size=jnp.asarray(VOXEL, jnp.float32),
                         grid_size=GRID, max_pillars=300, max_points_per_pillar=8)
           for p, m in clouds]
    return [np.stack([np.asarray(getattr(o, k)) for o in out])
            for k in ("voxels", "num_points", "coords", "mask")]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("filters", [[16], [8, 16]], ids=["one-pfn", "two-pfn"])
def test_pillar_vfe_matches_jax(pillars, filters, train):
    """(B, P, K, 4) pillars -> (B, P, C) features; in train mode the BN
    statistics over the occupied pillars' rows, and the running averages
    they update, match too."""
    kw = dict(num_filters=filters, voxel_size=[0.4, 0.4, 8.0],
              lidar_range=[-6.4, -6.4, -5.0, 6.4, 6.4, 3.0])
    jvfe = JaxPillarVFE(**kw)
    jin = [jnp.asarray(a) for a in pillars]
    var = random_variables(jvfe, *jin, seed=7, train=False)
    if train:
        want, upd = jvfe.apply(var, *jin, train=True, mutable=["batch_stats"])
    else:
        want = jvfe.apply(var, *jin, train=False)
    vfe = PillarVFE(**kw)
    load_flax_variables(vfe, var)
    vfe.train(train)
    tin = [torch.from_numpy(a) for a in pillars]
    with torch.no_grad():
        got = vfe(*tin)
    want = np.asarray(want)
    assert_close(got.numpy(), want, TOL, TOL, "features")
    assert np.abs(want).max() > 0 and (want[~pillars[3]] == 0).all()
    if train:
        for i, layer in enumerate(vfe.pfn):
            stats = upd["batch_stats"][f"PFNLayer_{i}"]["MaskedBatchNorm_0"]
            assert_close(layer.norm.running_mean.numpy(), stats["mean"], TOL,
                         TOL, "mean")
            assert_close(layer.norm.running_var.numpy(), stats["var"], TOL,
                         TOL, "var")


def test_scatters_match_jax(pillars):
    rng = np.random.default_rng(8)
    _, _, coords, mask = pillars
    feats = rng.normal(size=coords.shape[:2] + (6,)).astype(np.float32)
    want = jax_scatter.scatter_pillars_to_bev_batch(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask), ny=32, nx=32)
    got = scatter.scatter_pillars_to_bev_batch(
        torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(mask),
        ny=32, nx=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the 3D grid: spread the pillars over 3 z levels
    coords3 = coords.copy()
    coords3[..., 0] = np.arange(coords.shape[1]) % 3
    want = jax_scatter.scatter_voxels_to_grid_batch(
        jnp.asarray(feats), jnp.asarray(coords3), jnp.asarray(mask), nz=3, ny=32,
        nx=32)
    got = scatter.scatter_voxels_to_grid_batch(
        torch.from_numpy(feats), torch.from_numpy(coords3),
        torch.from_numpy(mask), nz=3, ny=32, nx=32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = scatter.scatter_voxels_to_grid(
        torch.from_numpy(feats[0]), torch.from_numpy(coords3[0]),
        torch.from_numpy(mask[0]), nz=3, ny=32, nx=32)
    assert torch.equal(one, got[0])


# --- the encoders' classic branches --------------------------------------------


def classic(hypes, filters):
    hypes["preprocess"]["args"]["fast_pillars"] = False
    args = hypes["model"]["args"]
    for t in ("vehicle", "rsu", "drone"):
        if isinstance(args.get(t), dict) and "lidar" in args[t]:
            args[t]["lidar"]["pillar_vfe"]["num_filters"] = list(filters)
    if "pillar_vfe" in args:
        args["pillar_vfe"]["num_filters"] = list(filters)
    return hypes


@pytest.mark.parametrize("filters", [[16], [8, 16]], ids=["one-pfn", "two-pfn"])
def test_hetero_encoder_classic_branch_matches_jax(filters):
    """The tiny Where2comm's per-type encoders: one pillarization of every
    cloud on the ego grid, each type's PillarVFE with its own z extent."""
    hypes = classic(jax_load_yaml(TINY), filters)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    batch, _ = jax_make_scene(np.random.default_rng(9), layout, num_objects=4,
                              points_per_agent=700, pts_per_box=40,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"],
                              num_agents={"vehicle": 2, "rsu": 1, "drone": 1})
    batch = {k: v[None] for k, v in batch.items()}
    jmodel = jax_build_model(hypes)
    var = random_variables(jmodel, jnp_tree(batch), seed=3, train=False)
    want = np.asarray(jmodel.apply(
        var, jnp_tree(batch), False,
        method=lambda m, b, train: m.encoder(b, train)))
    model = build_model(copy.deepcopy(hypes), device="cpu")
    load_flax_variables(model, var)
    assert not model.encoder.fast
    with torch.no_grad():
        got = model.encode(batch_to_torch(batch, "cpu"))
    assert got.shape == want.shape == (1, 4, 96, 96, 16)
    assert_close(got.numpy(), want, ENC_TOL * (1 + np.abs(want).max()), 0, "bev")
    present = batch["agent_mask"][0]
    assert all(np.abs(want[0, i]).max() > 0 for i in np.nonzero(present)[0])
    assert not want[0, ~present].any()


@pytest.mark.parametrize("filters", [[16], [8, 16]], ids=["one-pfn", "two-pfn"])
def test_flat_encoder_classic_branch_matches_jax(filters):
    """``PointPillarBase.encode`` of the flat family (3 slots, the third
    absent) on the classic path."""
    hypes = classic(flat_hypes("point_pillar"), filters)
    batch, _ = jax_make_scene(np.random.default_rng(10),
                              JaxSlotLayout(counts=(3, 0, 0)), num_objects=4,
                              points_per_agent=600, pts_per_box=40,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"])
    batch = {k: v[None] for k, v in batch.items()}
    batch["agent_mask"][0, 2] = False
    jmodel = jax_build_model(hypes)
    var = random_variables(jmodel, jnp_tree(batch), seed=4, train=False)
    want = np.asarray(jmodel.apply(
        var, jnp_tree(batch), False,
        method=lambda m, b, train: m.encode(b, train)))
    model = build_model(copy.deepcopy(hypes), device="cpu")
    load_flax_variables(model, var)
    assert not model.fast_pillars
    with torch.no_grad():
        got = model.encode(batch_to_torch(batch, "cpu"))
    assert got.shape == want.shape == (1, 3, 64, 64, 16)
    assert_close(got.numpy(), want, ENC_TOL * (1 + np.abs(want).max()), 0, "bev")
    assert np.abs(want[0, :2]).max() > 0 and not want[0, 2].any()
