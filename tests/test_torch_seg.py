"""The PyTorch port's LiDAR BEV-segmentation path against the JAX package:
the gather sampler, the seg head, the seg decode, the comm-mask resize at
the flagship seg shapes, and the tiny seg model under the ``auto`` and
``pallas`` conv backends (the JAX Pallas conv in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.postprocess import decode_segmentation as jax_decode_seg
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.heads import BevSegHead as JaxBevSegHead
from airv2x_tpu.ops.warp import grid_sample_bilinear as jax_grid_sample
from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.postprocess import decode_segmentation
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.where2comm import resize_comm_mask
from airv2x_tpu_torch.models.heads import BevSegHead
from airv2x_tpu_torch.ops.warp import grid_sample_bilinear
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import (
    SEG, TINY, assert_close, jnp_tree, nhwc_to_nchw, random_variables,
    tiny_seg)

TOL = 1e-5  # f32 module tests
TOL_MODEL = 1e-4  # whole-model outputs through ~40 conv layers, f32


def _grid(rng, shape, lo, hi):
    g = rng.uniform(lo, hi, shape).astype(np.float32)
    g.flat[:4] = [lo, hi, 0.0, 2.0]  # out of range and on integer pixels
    return g


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
def test_grid_sample_bilinear(lead):
    rng = np.random.default_rng(0)
    src = rng.normal(size=lead + (5, 7, 3)).astype(np.float32)
    gx = _grid(rng, (4, 6), -1.5, 7.5)
    gy = _grid(rng, (4, 6), -1.5, 5.5)
    flat = src.reshape((-1, 5, 7, 3))
    want = np.stack([np.asarray(jax_grid_sample(jnp.asarray(s), gx, gy))
                     for s in flat]).reshape(lead + (4, 6, 3))
    got = grid_sample_bilinear(*map(torch.from_numpy, (src, gx, gy)))
    assert got.shape == lead + (4, 6, 3)
    assert_close(got.numpy(), want, TOL, TOL, "grid_sample")


def test_grid_sample_bf16_src_gives_f32():
    src = torch.ones(4, 4, 2, dtype=torch.bfloat16)
    g = torch.full((3, 3), 1.25)
    out = grid_sample_bilinear(src, g, g)
    assert out.dtype == torch.float32
    assert torch.allclose(out, torch.ones_like(out))


# 80 m x 40 m feature maps at 0.4 px/m: an extent of 9.6 m is cropped in
# both axes, 19.2 m padded in rows and cropped in columns, 48 m padded in
# both
@pytest.mark.parametrize("seg_res", [0.4, 0.8, 2.0])
@pytest.mark.parametrize("branch", ["both", "dynamic", "static"])
def test_bev_seg_head(seg_res, branch):
    cav_range = [-40.0, -20.0, -3.0, 40.0, 20.0, 1.0]
    kw = dict(seg_branch=branch, seg_hw=24, dynamic_class=7, static_class=3,
              seg_res=seg_res, cav_range=cav_range)
    x = np.random.default_rng(1).normal(size=(2, 16, 32, 8)).astype(np.float32)
    jmod = JaxBevSegHead(**kw)
    var = random_variables(jmod, jnp.asarray(x), seed=2,
                           return_features=True)
    want, want_feats = jmod.apply(var, jnp.asarray(x), return_features=True)
    tmod = BevSegHead(8, **kw)
    load_flax_variables(tmod, var)
    with torch.no_grad():
        tx = nhwc_to_nchw(x)
        got = tmod(tx)
        feats = tmod.crop(tx).permute(0, 2, 3, 1).numpy()
    assert_close(feats, np.asarray(want_feats), 0, 0, "crop/pad")
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].shape[1:3] == (24, 24)
        assert_close(got[k].numpy(), np.asarray(want[k]), TOL, TOL, k)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_segmentation(dtype):
    rng = np.random.default_rng(3)
    dyn = rng.normal(0, 3, (2, 16, 16, 7)).astype(np.float32)
    sta = rng.normal(0, 3, (2, 16, 16, 3)).astype(np.float32)
    dyn[0, :4, :, 2:5] = 40.0  # saturated sigmoid: a three-way tie
    dyn[1, :, :3, 0] = dyn[1, :, :3, 6] = 60.0
    sta[0, 0] = 0.0
    dyn, sta = (np.array(jnp.asarray(a, dtype).astype(jnp.float32))
                for a in (dyn, sta))
    want = jax_decode_seg(jnp.asarray(dyn, dtype), jnp.asarray(sta, dtype))
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = decode_segmentation(torch.from_numpy(dyn).to(tdt),
                              torch.from_numpy(sta).to(tdt))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][0, :4] == 2).all() and (got[0][1, :, :3] == 0).all()


@pytest.mark.parametrize("src,dst", [((160, 160), (100, 352)),
                                     ((30, 30), (48, 48))])
def test_comm_mask_resize(src, dst):
    """The flagship seg path resizes the 160 x 160 comm mask to stage 0's
    100 x 352, down in rows and up in columns in one call; the tiny seg
    model 30 x 30 to 48 x 48."""
    rng = np.random.default_rng(4)
    m = (rng.uniform(size=(2, 3) + src) > 0.4).astype(np.float32)
    m[0, 0] = rng.uniform(size=src)
    want = jax.image.resize(jnp.asarray(m), (2, 3) + dst, method="bilinear")
    got = resize_comm_mask(torch.from_numpy(m), dst)
    assert_close(got.numpy(), np.asarray(want), 1e-6, 0, "resize")


def test_flagship_seg_config_shapes():
    """The flagship seg config crops its 100 x 352 stage-0 map to the
    160 x 160 seg extent, the shape pair above."""
    model = build_model(load_yaml(SEG), device="cpu")
    feats = torch.zeros(1, 256, 100, 352)
    assert model.seg_head.crop(feats).shape == (1, 256, 160, 160)
    assert model.seg_head.seg_hw == 512


@pytest.fixture(scope="module")
def tiny_seg_run():
    hypes = tiny_seg(jax_load_yaml(TINY))
    jmodel = jax_build_model(hypes)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(0)
    scenes = [
        jax_make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                       lidar_range=hypes["preprocess"]["cav_lidar_range"],
                       pts_per_box=60, num_agents=na)[0]
        for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
                   {"vehicle": 1, "rsu": 1, "drone": 0})
    ]
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    var = random_variables(jmodel, jnp_tree(batch), seed=22, train=False)
    tmodel = build_model(tiny_seg(load_yaml(TINY)), device="cpu")
    load_flax_variables(tmodel, var)
    return jmodel, var, batch, tmodel


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_tiny_seg_model_matches_jax(tiny_seg_run, monkeypatch, mode):
    jmodel, var, batch, tmodel = tiny_seg_run
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)  # read at trace / forward
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        var, jnp_tree(batch))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    assert kernels.LAUNCHES["conv3x3"] == 0  # the CPU runs the plain version
    assert set(got) == {"dynamic_seg", "static_seg", "comm_rate"}
    for k in ("dynamic_seg", "static_seg"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape == (2, 96, 96, w.shape[-1])
        scale = float(np.abs(w).max())
        assert scale > 0
        lim = TOL_MODEL * (1 + scale)
        assert_close(got[k].numpy(), w, lim, 0, k)
    assert float(got["comm_rate"]) == pytest.approx(
        float(want["comm_rate"]), abs=TOL_MODEL)
    dyn, sta = decode_segmentation(got["dynamic_seg"], got["static_seg"])
    jdyn, jsta = jax_decode_seg(want["dynamic_seg"], want["static_seg"])
    # the class maps agree wherever the top two classes are apart
    for g, w, logits in ((dyn, jdyn, want["dynamic_seg"]),
                         (sta, jsta, want["static_seg"])):
        top2 = np.sort(np.asarray(jax.nn.sigmoid(logits)), -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(g.numpy()[clear], np.asarray(w)[clear])
