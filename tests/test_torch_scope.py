"""SCOPE's modules in the PyTorch port against the JAX package, f32, through
the weight bridge: the normalized-coordinate warps (ops/warp.py), the
ResNet BEV backbone (models/resnet_bev.py), ``PointPillarBase`` on both
backbones (models/point_pillar_models.py), the deformable attention
(models/fusion/msda.py), SCOPE's communication, fusions, temporal LSTM
chain and late fusion (models/fusion/scope.py) and the history warp
(models/fusion/temporal.py). The whole model is in
tests/test_torch_scope_model.py.

Poses here are a few degrees and metres off the identity, so every warp
moves features; thresholded inputs keep a stated margin from their
threshold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models import resnet_bev as jrb
from airv2x_tpu.models.fusion import msda as jmsda
from airv2x_tpu.models.fusion import scope as jscope
from airv2x_tpu.models.fusion import temporal as jtemporal
from airv2x_tpu.ops import warp as jwarp
from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.fusion import msda as tmsda
from airv2x_tpu_torch.models.fusion import scope as tscope
from airv2x_tpu_torch.models.fusion.temporal import warp_history_to_current
from airv2x_tpu_torch.models.point_pillar_models import PointPillarBase
from airv2x_tpu_torch.models.resnet_bev import ResNetBEVBackbone
from airv2x_tpu_torch.ops import warp as twarp
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import (
    CHIP_SMOKE, assert_close, jnp_tree, one_torch_thread, random_variables)

TOL = 1e-5  # modules, f32, x (1 + scale): sums in another order
MARGIN = 1e-4  # a thresholded value this close could fall either side


def _poses(seed, shape):
    """``shape`` + (4, 4) planar poses: yaw within 5 degrees, xy within 3 m."""
    rng = np.random.default_rng(seed)
    out = np.broadcast_to(np.eye(4, dtype=np.float32), shape + (4, 4)).copy()
    yaw = np.deg2rad(rng.uniform(-5, 5, shape))
    out[..., 0, 0] = out[..., 1, 1] = np.cos(yaw)
    out[..., 0, 1], out[..., 1, 0] = -np.sin(yaw), np.sin(yaw)
    out[..., :2, 3] = rng.uniform(-3, 3, shape + (2,))
    return out


def _x(seed, shape, loc=0.0):
    return np.random.default_rng(seed).normal(loc, 1, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    """(..., H, W, C) numpy -> (..., C, H, W) tensor."""
    return _t(np.moveaxis(a, -1, -3))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), -3, -1)


def _module(jmod, tmod, jargs, seed, **kw):
    """Seeded flax variables of ``jmod`` (called on ``jargs``) into
    ``tmod``; returns (JAX output, the variables)."""
    var = random_variables(jmod, *jargs, seed=seed, **kw)
    load_flax_variables(tmod, var)
    return jmod.apply(var, *jargs, **kw), var


def _close(got, want, what, tol=TOL):
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    assert_close(got, want, tol * (1 + scale), 0, what)


# --- the normalized-coordinate warps ---------------------------------------

def test_normalized_pairwise_affine_matches_jax():
    pt = _poses(0, (2, 3))
    want = np.asarray(jwarp.normalized_pairwise_affine(jnp.asarray(pt), 100, 352,
                                                       0.4, 2))
    got = twarp.normalized_pairwise_affine(_t(pt), 100, 352, 0.4, 2).numpy()
    _close(got, want, "normalized_pairwise_affine")
    assert np.abs(want[..., 2]).max() > 0.01  # translated
    assert np.abs(want[..., 0, 1]).max() > 0.01  # rotated, aspect-scaled


def test_warp_affine_normalized_matches_jax():
    src = _x(1, (2, 3, 12, 20, 5))
    m = np.asarray(jwarp.normalized_pairwise_affine(
        jnp.asarray(_poses(2, (2, 3))), 12, 20, 0.4, 1))
    want = np.asarray(jwarp.warp_affine_normalized(jnp.asarray(src),
                                                   jnp.asarray(m)))
    got = twarp.warp_affine_normalized(_t(src), _t(m)).numpy()
    _close(got, want, "warp_affine_normalized")
    assert np.abs(want - src).max() > 0.5  # really moved


def test_warp_history_to_current_matches_jax():
    feats = _x(3, (2, 3, 16, 24, 8))
    delta = _poses(4, (2, 3))
    delta[:, 0] = np.eye(4)  # the current frame stays
    want = np.asarray(jtemporal.warp_history_to_current(
        jnp.asarray(feats), jnp.asarray(delta), 0.4, 2))
    got = warp_history_to_current(_t(feats), _t(delta), 0.4, 2)
    _close(got.numpy(), want, "warp_history_to_current")
    # the identity samples every pixel centre (within rounding)
    np.testing.assert_allclose(got[:, 0].numpy(), feats[:, 0], atol=TOL)
    bf = warp_history_to_current(_t(feats).bfloat16(), _t(delta), 0.4, 2)
    assert bf.dtype == torch.float32  # f32 weights, as in JAX


# --- the ResNet backbone and PointPillarBase -------------------------------

def test_resnet_backbone_matches_jax():
    kw = dict(layer_nums=[2, 1], layer_strides=[2, 2], num_filters=[16, 32],
              upsample_strides=[1, 2], num_upsample_filters=[8, 8])
    x = _x(5, (2, 20, 28, 8))  # 10 x 14 -> 5 x 7: the padding (1, 1) matters
    tmod = ResNetBEVBackbone(inplanes=8, **kw)
    (want, want_feats), _ = _module(jrb.ResNetBEVBackbone(inplanes=8, **kw),
                                    tmod, (jnp.asarray(x),), 6)
    with torch.no_grad():
        got, feats = tmod.eval()(_nchw(x))
    _close(_nhwc(got), want, "ResNetBEVBackbone")
    for i, (g, w) in enumerate(zip(feats, want_feats)):
        _close(_nhwc(g), w, f"stage {i}")
    assert [f.shape[-2:] for f in feats] == [(10, 14), (5, 7)]
    blk = tmod.stages[0].blocks[0]
    assert blk.down_conv is not None and tmod.stages[0].blocks[1].down_conv is None


def _tiny_args(resnet, num_class=1):
    hypes = CHIP_SMOKE.tiny_scope_hypes(resnet)
    args = dict(hypes["model"]["args"], preprocess=hypes["preprocess"],
                num_class=num_class)
    return hypes, args


@pytest.mark.parametrize("resnet,num_class", [(True, 1), (False, 1), (True, 2)],
                         ids=["resnet", "plain", "resnet-multiclass"])
def test_point_pillar_base_matches_jax(resnet, num_class):
    """The spine without a fusion (the JAX package's ``point_pillar``): one
    frame, one of the three slots absent; the multiclass layout adds the
    objectness head; in eval and in train mode."""
    hypes, args = _tiny_args(resnet, num_class)
    hypes["model"]["core_method"] = "point_pillar"
    hypes["model"]["args"]["num_class"] = num_class
    layout = SlotLayout.from_args(args)
    b, _ = make_scene(np.random.default_rng(7), layout, num_objects=6,
                      points_per_agent=1024, pts_per_box=60,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"],
                      num_agents={"vehicle": 2})
    batch = {k: v[None] for k, v in b.items()}
    jmodel = jax_build_model(hypes)
    var = random_variables(jmodel, jnp_tree(batch), seed=8, train=False)
    want = jmodel.apply(var, jnp_tree(batch), train=False)
    tmodel = PointPillarBase(args).eval()
    load_flax_variables(tmodel, var)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    keys = {"psm", "rm", "comm_rate"} | ({"obj"} if num_class > 1 else set())
    assert set(got) == set(want) == keys
    for k in keys - {"comm_rate"}:
        _close(got[k].numpy(), want[k], k)
    assert got["psm"].shape == (1, 32, 32, 2 * num_class)
    # train mode (the plain scatter encoder, batch statistics) as flax's, at
    # the whole-model tolerance: batch statistics over one scene amplify
    # either package's f32 rounding (the train steps are held to JAX's
    # float64 step in tests/test_torch_point_pillar_family.py)
    want, _ = jmodel.apply(var, jnp_tree(batch), train=True,
                           mutable=["batch_stats"])
    with torch.no_grad():
        got = tmodel.train()(batch_to_torch(batch, "cpu"))
    for k in keys - {"comm_rate"}:
        _close(got[k].numpy(), want[k], k, tol=1e-4)


def test_point_pillar_base_raises_on_unported_options():
    """``compression`` raises; two PFN layers, once refused, take the
    classic voxel path (tests/test_torch_voxel_path.py holds it)."""
    _, args = _tiny_args(True)
    with pytest.raises(NotImplementedError):
        PointPillarBase(dict(args, compression=4))
    model = PointPillarBase(dict(args, pillar_vfe=dict(args["pillar_vfe"],
                                                       num_filters=[16, 16])))
    assert not model.fast_pillars and len(model.vfe.pfn) == 2


# --- the deformable attention ----------------------------------------------

def test_sample_bilinear_zeros_matches_jax():
    img = _x(9, (6, 9, 4))
    rng = np.random.default_rng(10)
    x = rng.uniform(-2, 10, (3, 7)).astype(np.float32)  # some taps outside
    y = rng.uniform(-2, 7, (3, 7)).astype(np.float32)
    want = np.asarray(jmsda.sample_bilinear_zeros(*map(jnp.asarray, (img, x, y))))
    got = tmsda.sample_bilinear_zeros(_t(img), _t(x), _t(y)).numpy()
    assert got.shape == (3, 7, 4)
    _close(got, want, "sample_bilinear_zeros")


def _msda_inputs(seed, b=2, lq=12, lv=3, h=8, w=12, c=32):
    rng = np.random.default_rng(seed)
    query = rng.normal(0, 1, (b, lq, c)).astype(np.float32)
    ref = rng.uniform(0, 1, (b, lq, lv, 2)).astype(np.float32)
    src = rng.normal(0, 1, (b, lv, h, w, c)).astype(np.float32)
    return query, ref, src


def test_msdeform_attn_matches_jax():
    query, ref, src = _msda_inputs(11)
    kw = dict(d_model=32, d_head=16, n_levels=3, n_heads=4, n_points=5)
    tmod = tmsda.MSDeformAttn(**kw)
    want, _ = _module(jmsda.MSDeformAttn(**kw), tmod,
                      tuple(map(jnp.asarray, (query, ref, src))), 12)
    with torch.no_grad():
        got = tmod(_t(query), _t(ref), _t(src)).numpy()
    _close(got, want, "MSDeformAttn")


def test_deform_transformer_matches_jax():
    query, ref, src = _msda_inputs(13)
    center = ref[:, :, 0]
    kw = dict(dim=32, depth=2, heads=4, levels=3, dim_head=16, mlp_dim=48,
              n_points=9)
    tmod = tmsda.DeformTransformer(**kw)
    want, var = _module(jmsda.DeformTransformer(**kw), tmod,
                        tuple(map(jnp.asarray, (query, src, center))), 14)
    assert "layer1_cross_attn" in var["params"]
    with torch.no_grad():
        got = tmod(_t(query), _t(src), _t(center)).numpy()
    _close(got, want, "DeformTransformer")


def test_deformable_query_refine_matches_jax():
    """Three slots (the last zero, as an absent agent's), 96 cells, 40
    queries: the 40th and 41st scores lie apart by more than the margin."""
    x = _x(15, (2, 3, 8, 12, 32))
    x[:, 2] = 0.0
    psm = np.random.default_rng(16).uniform(0, 1, (2, 3, 8, 12, 1)).astype(
        np.float32)
    psm[:, 2] = 0.0
    s = np.sort(psm[..., 0].sum(1).reshape(2, -1), axis=1)[:, ::-1]
    gap = ((s[:, 39] - s[:, 40]) / np.abs(s).max(1)).min()
    assert gap > MARGIN, gap
    kw = dict(channels=32, n_points=9, num_queries=40, max_cav=3)
    tmod = tmsda.DeformableQueryRefine(**kw)
    want, _ = _module(jmsda.DeformableQueryRefine(**kw), tmod,
                      (jnp.asarray(x), jnp.asarray(psm)), 17)
    with torch.no_grad():
        got = tmod(_t(x), _t(psm[..., 0])).numpy()
    _close(got, want, "DeformableQueryRefine")
    # cells outside the top 40 keep the ego's features
    kept = np.abs(got - x[:, 0]).max(-1) == 0
    assert (kept.reshape(2, -1).sum(1) == 96 - 40).all()


def test_query_ties_keep_the_lower_cell_first():
    """A stable descending sort: among equal scores the lower cell index
    becomes a query, as ``jax.lax.top_k`` picks."""
    mod = tmsda.DeformableQueryRefine(16, n_points=1, num_queries=3, max_cav=2)
    x = torch.zeros(1, 2, 2, 3, 16)
    psm = torch.zeros(1, 2, 2, 3)
    psm[0, 0, 1, 2] = 1.0  # cell 5 first, then the ties 0 and 1
    picked = []
    mod.transformer.register_forward_hook(
        lambda m, args, out: picked.append(args[2]))
    with torch.no_grad():
        mod(x, psm)
    cells = (picked[0][0, :, 1] * 2 * 3 + picked[0][0, :, 0] * 3).round()
    np.testing.assert_array_equal(cells.numpy(), [5, 0, 1])


# --- SCOPE's communication, fusions, temporal chain, late fusion -----------

def test_scope_communication_matches_jax():
    """Four slots (the odd ones thresholded, the even ones sending all),
    slot 3 of sample 1 absent; logits around -5 put the smoothed
    confidence on both sides of 0.01. Seed 31: the first from 18 up whose
    thresholded samples all lie more than MARGIN from 0.01."""
    psm = _x(31, (2, 4, 6, 8, 2), loc=-5.0)
    agent_mask = np.array([[True] * 4, [True, True, True, False]])
    mask, rate, smooth = jscope.ScopeCommunication(0.01, 5, 1.0).apply(
        {}, jnp.asarray(psm), jnp.asarray(agent_mask))
    smooth = np.asarray(smooth)[..., 0]
    thresholded = np.abs(smooth - 0.01)[:, 1::2][agent_mask[:, 1::2]]
    assert thresholded.min() > MARGIN
    got = tscope.ScopeCommunication(0.01, 5, 1.0)(
        _nchw(psm), _t(agent_mask))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(mask)[..., 0])
    assert float(got[1]) == float(rate)
    _close(got[2].numpy(), smooth, "smoothed confidence")
    odd = np.asarray(mask)[:, 1::2][agent_mask[:, 1::2]]
    assert 0 < odd.mean() < 1  # the threshold decides there
    assert (np.asarray(mask)[:, 0] == 1).all() and (np.asarray(mask)[1, 3] == 0).all()


@pytest.mark.parametrize("fusion", ["atten", "max"])
def test_scope_fusions_match_jax(fusion):
    x = _x(19, (2, 3, 6, 8, 16))
    agent_mask = np.array([[True, True, True], [True, False, True]])
    if fusion == "atten":
        want = jscope.atten_fusion(jnp.asarray(x), jnp.asarray(agent_mask))
        got = tscope.atten_fusion(_t(x), _t(agent_mask))
    else:
        want = jscope.max_fusion(jnp.asarray(x))
        got = tscope.max_fusion(_t(x))
    _close(got.numpy(), want, fusion)


def _temporal_case(name):
    """(flax module, port module, JAX inputs (NHWC), port inputs (NCHW))."""
    if name == "STPNMotionLSTM":
        x = _x(20, (2, 8, 12, 16))
        return (jscope.STPNMotionLSTM(16), tscope.STPNMotionLSTM(16),
                (jnp.asarray(x),), (_nchw(x),))
    if name == "MotionLSTM":
        x, h, c = (_x(21 + i, (2, 8, 12, 16)) for i in range(3))
        return (jscope.MotionLSTM(16, 8, 12), tscope.MotionLSTM(16, 8, 12),
                tuple(map(jnp.asarray, (x, h, c))), tuple(map(_nchw, (x, h, c))))
    if name == "SpatialAttentionMTF":
        hist = _x(24, (2, 3, 8, 12, 16))
        return (jscope.SpatialAttentionMTF(), tscope.SpatialAttentionMTF(),
                (jnp.asarray(hist[:, :1]), jnp.asarray(hist[:, 1:])),
                (_nchw(hist[:, :1]), _nchw(hist[:, 1:])))
    channel = int(name.split("-")[1])
    hist = _x(25, (2, 3, 8, 12, channel))  # three frames: two LSTM steps
    if name.startswith("SyncLSTM"):
        return (jscope.SyncLSTM(channel, 8, 12), tscope.SyncLSTM(channel, 8, 12),
                (jnp.asarray(hist),), (_nchw(hist),))
    return (jscope.TemporalFusionLSTM(channel, 8, 12),
            tscope.TemporalFusionLSTM(channel, 8, 12), (jnp.asarray(hist),),
            (_nchw(hist),))


@pytest.mark.parametrize("name", [
    "STPNMotionLSTM", "MotionLSTM", "SpatialAttentionMTF", "SyncLSTM-32",
    "SyncLSTM-256", "TemporalFusionLSTM-32", "TemporalFusionLSTM-256"])
def test_temporal_chain_matches_jax(name):
    """The chain's modules, bottom up; SyncLSTM at 32 channels (expanded to
    the 64-channel cell) and 256 (compressed by 2, as the config's)."""
    jmod, tmod, jargs, targs = _temporal_case(name)
    want, var = _module(jmod, tmod, jargs, 26)
    with torch.no_grad():
        got = tmod.eval()(*targs)
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for i, (g, w) in enumerate(zip(outs, wants)):
        _close(_nhwc(g), w, f"{name} output {i}")
    if name == "MotionLSTM":  # the raw biases permuted from (1, H, W, C)
        np.testing.assert_array_equal(
            _nhwc(tmod.b_o), var["params"]["b_o"])


def test_late_fusion_matches_jax():
    feats = [_x(27 + i, (2, 8, 12, 16)) for i in range(3)]
    psms = [_x(30 + i, (2, 8, 12, 2)) for i in range(3)]
    want = jscope.ScopeLateFusion(0.01, 5, 1.0).apply(
        {}, [jnp.asarray(f) for f in feats], *map(jnp.asarray, psms))
    got = tscope.ScopeLateFusion(5, 1.0)([_nchw(f) for f in feats],
                                         *map(_nchw, psms))
    _close(_nhwc(got), want, "ScopeLateFusion")
