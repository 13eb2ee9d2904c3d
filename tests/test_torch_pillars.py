"""The PyTorch port's pillar encoder against the JAX package: point cell ids,
K1's plain version against the Pallas kernel in interpret mode, the
FastPillarBEV eval path on both JAX paths, and the hetero encoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models.base import HeteroLidarEncoder as JaxEncoder
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.nn import MaskedBatchNorm as JaxMaskedBatchNorm
from airv2x_tpu.ops.fast_pillars import FastPillarBEV as JaxFastPillarBEV
from airv2x_tpu.ops.fast_pillars import point_cell_ids as jax_point_cell_ids
from airv2x_tpu.ops.pallas_pillars import FEAT, LANES, NEG, fused_pillar_encode
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models.base import HeteroLidarEncoder, SlotLayout
from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV, point_cell_ids
from airv2x_tpu_torch.ops.pillar_encode import pillar_encode
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import TINY, assert_close, random_variables

TOL = 1e-5  # f32 module tests

TINY_ARGS = jax_load_yaml(TINY)["model"]["args"]
TINY_PRE = jax_load_yaml(TINY)["preprocess"]
GRID_LR = TINY_PRE["cav_lidar_range"]
GRID_VS = TINY_PRE["args"]["voxel_size"]


def _points(rng, lead, n, lr=GRID_LR):
    pts = np.empty(lead + (n, 4), np.float32)
    pad = 1.0
    pts[..., 0] = rng.uniform(lr[0] - pad, lr[3] + pad, lead + (n,))
    pts[..., 1] = rng.uniform(lr[1] - pad, lr[4] + pad, lead + (n,))
    pts[..., 2] = rng.uniform(lr[2] - 0.5, lr[5] + 0.5, lead + (n,))
    pts[..., 3] = rng.uniform(0, 1, lead + (n,))
    # crowd a corner so that cells hold many points
    pts[..., :40, :2] = rng.uniform(-1.0, 1.0, lead + (40, 2))
    mask = rng.uniform(size=lead + (n,)) > 0.1
    return pts, mask


def test_point_cell_ids_match():
    rng = np.random.default_rng(0)
    pts, mask = _points(rng, (3,), 500)
    nx = ny = 96
    ids, valid = point_cell_ids(torch.from_numpy(pts), torch.from_numpy(mask),
                                GRID_LR, GRID_VS, nx, ny)
    jids, jvalid = jax_point_cell_ids(jnp.asarray(pts), jnp.asarray(mask),
                                      GRID_LR, GRID_VS, nx, ny)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert valid.any() and not valid.all()


def _to_pallas_layout(ids, feat, aux, params, cells):
    """The port's interface -> the TPU kernel's dump row + 128-lane packing."""
    m, n, c = feat.shape
    valid = (ids >= 0) & (ids < cells)
    vals = np.zeros((m, n, LANES), np.float32)
    vals[..., :FEAT] = NEG
    vals[..., :c] = np.where(valid[..., None], feat, NEG)
    vals[..., FEAT:FEAT + 4] = aux
    par = np.zeros((8, LANES), np.float32)
    par[:7, :c] = params
    return np.where(valid, ids, cells).astype(np.int32), vals, par


def _k1_case(kind):
    rng = np.random.default_rng(1)
    c = 16
    if kind == "empty":
        m, n, nx, ny = 2, 64, 12, 10
        ids = np.full((m, n), nx * ny, np.int32)
    elif kind == "rows_at_nx_multiples":  # flagship width, cf. test_fast_pillars
        m, n, nx, ny = 1, 512, 704, 3
        ids = rng.integers(0, nx * ny, (m, n)).astype(np.int32)
        ids[0, :5] = [0, nx, 2 * nx, 3 * nx - 1, nx - 1]
    else:
        m, n, nx, ny = 2, 300, 12, 10
        ids = rng.integers(-1, nx * ny + 1, (m, n)).astype(np.int32)
        ids[:, :30] = 7  # one hot cell
    feat = rng.normal(0, 2, (m, n, c)).astype(np.float32)
    w = ((ids >= 0) & (ids < nx * ny)).astype(np.float32)[..., None]
    aux = np.concatenate([w, rng.uniform(-0.2, 0.2, (m, n, 3)) * w], -1)
    params = rng.normal(0, 1, (7, c)).astype(np.float32)
    params[5] = np.where(rng.uniform(size=c) > 0.4, 1.0, -1.0)
    params[6] = np.abs(params[6])
    consts = (0.4, 0.4, -140.6, -0.4, -1.0)
    return ids, feat, aux.astype(np.float32), params, nx, ny, consts


@pytest.mark.parametrize("kind", ["random", "rows_at_nx_multiples", "empty"])
def test_k1_plain_matches_pallas_interpret(kind):
    ids, feat, aux, params, nx, ny, consts = _k1_case(kind)
    cells = nx * ny
    got = pillar_encode(*(torch.from_numpy(a) for a in (ids, feat, aux, params)),
                        cells=cells, nx=nx, grid_consts=consts)
    jids, vals, par = _to_pallas_layout(ids, feat, aux, params, cells)
    want = fused_pillar_encode(jnp.asarray(jids), jnp.asarray(vals),
                               jnp.asarray(par), cells=cells, nx=nx,
                               grid_consts=consts, out_dtype=jnp.float32,
                               interpret=True)
    want = np.asarray(want)[..., :feat.shape[-1]]
    assert_close(got.numpy(), want, TOL, TOL, kind)
    if kind == "empty":
        assert float(got.abs().max()) == 0.0
    else:
        assert float(got.abs().max()) > 0.0


def _jax_fast(agent, num_filters=16):
    cfg = TINY_ARGS[agent]["lidar"]
    return dict(num_filters=[num_filters], voxel_size=GRID_VS, lidar_range=GRID_LR,
                use_norm=True, with_distance=False, use_absolute_xyz=True,
                offset_voxel_size=cfg["voxel_size"],
                offset_lidar_range=cfg["lidar_range"])


@pytest.fixture(scope="module")
def fast_cases():
    """Per agent type: JAX module, random variables, port module, inputs."""
    rng = np.random.default_rng(2)
    pts, mask = _points(rng, (2,), 700)
    out = {}
    for seed, agent in enumerate(("vehicle", "rsu", "drone")):
        kw = _jax_fast(agent)
        jmod = JaxFastPillarBEV(**kw)
        var = random_variables(jmod, jnp.asarray(pts), jnp.asarray(mask),
                               seed=10 + seed, train=False)
        tmod = FastPillarBEV(**kw).eval()
        load_flax_variables(tmod, var)
        out[agent] = (jmod, var, tmod)
    return pts, mask, out


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
@pytest.mark.parametrize("agent", ["vehicle", "rsu", "drone"])
def test_fast_pillar_bev_matches_jax(fast_cases, monkeypatch, agent, jax_path):
    pts, mask, cases = fast_cases
    jmod, var, tmod = cases[agent]
    # "pallas" runs the fused kernel in interpret mode on the CPU
    monkeypatch.setenv("AIRV2X_PILLAR_KERNEL", jax_path)
    want = np.asarray(jmod.apply(var, jnp.asarray(pts), jnp.asarray(mask),
                                 train=False))
    with torch.no_grad():
        got = tmod(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (2, 96, 96, 16)
    assert_close(got, want, TOL, TOL, f"{agent}/{jax_path}")
    assert np.abs(want).max() > 0
    # some channels are flipped (negative BN scale)
    assert (var["params"]["MaskedBatchNorm_0"]["scale"] < 0).any()


def test_bn_affine_matches_jax_probe(fast_cases):
    """The port reads the eval BN affine as a = scale / sqrt(var + eps),
    b = bias - mean * a; the JAX module probes bn(0) and bn(I)."""
    _, _, cases = fast_cases
    _, var, tmod = cases["drone"]
    c = 16
    probe = JaxMaskedBatchNorm().apply(
        {"params": var["params"]["MaskedBatchNorm_0"],
         "batch_stats": var["batch_stats"]["MaskedBatchNorm_0"]},
        jnp.concatenate([jnp.zeros((1, c)), jnp.eye(c)]),
        jnp.zeros((c + 1,), bool), False)
    b_want = np.asarray(probe[0])
    a_want = np.diagonal(np.asarray(probe[1:])) - b_want
    with torch.no_grad():
        a, b = tmod.bn.affine()
    assert_close(a.numpy(), a_want, 1e-6, 1e-6, "a")
    assert_close(b.numpy(), b_want, 1e-6, 1e-6, "b")


def test_hetero_encoder_matches_jax():
    hypes = jax_load_yaml(TINY)
    args, pre = hypes["model"]["args"], hypes["preprocess"]
    jlayout = JaxSlotLayout.from_args(args)
    rng = np.random.default_rng(3)
    scenes = [
        jax_make_scene(rng, jlayout, num_objects=5, points_per_agent=600,
                       lidar_range=pre["cav_lidar_range"], pts_per_box=60,
                       num_agents=na)[0]
        for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
                   {"vehicle": 1, "rsu": 1, "drone": 0})
    ]
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jenc = JaxEncoder(args=args, preprocess=pre, layout=jlayout,
                      max_pillars=1024, max_points_per_pillar=8)
    var = random_variables(jenc, jbatch, seed=4, train=False)
    want = np.asarray(jax.jit(lambda v, b: jenc.apply(v, b, train=False))(
        var, jbatch))

    tenc = HeteroLidarEncoder(load_yaml(TINY)["model"]["args"], pre,
                              SlotLayout.from_args(args)).eval()
    load_flax_variables(tenc, var)
    with torch.no_grad():
        got = tenc({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == want.shape == (2, 4, 96, 96, 16)
    assert_close(got, want, TOL, TOL, "encoder")
    assert np.abs(got[1, 1]).max() == 0.0  # absent agent slot zeroed
