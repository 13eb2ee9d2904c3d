"""The PyTorch port's camera-LSS path against the JAX package: the frustum,
depth-bin and geometry helpers, voxel pooling, the resize helpers, each
trunk / LSS module through the weight bridge (the EfficientNet and the
truncated resnet101 trunks), the whole tiny camera model
(camera only, and LiDAR + camera on the vehicles) under the ``auto`` and
``pallas`` conv backends with its decoded keep sets, a bf16 eval against
JAX bf16, and the serving cast's f32 BatchNorms."""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.data.synthetic import add_camera_inputs as jax_add_camera_inputs
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.camera import lss as jlss
from airv2x_tpu.models.camera import trunks as jtrunks
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.camera import lss, trunks
from airv2x_tpu_torch.models.nn import MaskedBatchNorm
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.utils.weights import cast_weights_, load_flax_variables
from tests.torch_port_helpers import (
    TINY, assert_close, nchw_to_nhwc, nhwc_to_nchw, one_torch_thread,
    random_variables)



TOL = 1e-5  # f32 module tests, x (1 + scale)
TOL_MODEL = 1e-4  # whole-model outputs, x (1 + scale)
GEOM_TOL = 1e-6  # geometry, x (1 + scale): one or two f32 ulps
# a frustum point this close to a cell boundary, in cell widths, could land
# in the neighbouring cell in one of the two packages (their geometry
# agrees to ~1e-6 m, 2.5e-6 of a 0.4 m cell)
CELL_MARGIN = 1e-4
# a depth whose exact bin coordinate lies this close to a bin edge may round
# to either side in f32 (the coordinate's f32 error is ~1e-6)
BIN_MARGIN = 1e-5
TOP_K = 256
CONF = 0.012863  # a near-constant confidence: see tests/test_torch_where2comm.py
# bf16 whole-model eval against JAX bf16, x (1 + scale). Measured on these
# configs (batch seed 3, variables seed 30): the port's bf16 psm / rm / obj
# lie 0.031 / 0.30 / 2.39 from JAX bf16 (camera only, scales 4.4 / 2.1 /
# 17.7) and 0.000 / 0.068 / 0.63 (LiDAR + camera, 4.4 / 3.1 / 19.9), while
# JAX's own bf16 lies 0.020 / 0.23 / 1.96 and 0.019 / 0.074 / 0.47 from its
# f32 outputs and the port's bf16 0.020 / 0.16 / 1.24 and 0.019 / 0.045 /
# 0.33: both sides' bf16 rounding, through ~100 conv layers of the trunks,
# the BEV encoder and the backbone, amplified by the ego attention.
BF16_TOL = 0.15

# the camera block of tests/test_camera.py's tiny model
CAM_CFG = {
    "grid_conf": {
        "xbound": [-19.2, 19.2, 0.4],
        "ybound": [-19.2, 19.2, 0.4],
        "zbound": [-10, 10, 20.0],
        "ddiscr": [2, 50, 8],
        "mode": "LID",
    },
    "data_aug_conf": {"final_dim": [64, 96]},
    "img_downsample": 8,
    "img_features": 16,
    "bevout_feature": 16,
    "camera_encoder": "EfficientNet",
    "use_depth_gt": True,
    "depth_supervision": False,
}
NCAM = {"vehicle": 2, "rsu": 1, "drone": 1}


def _rel_close(got, want, tol, what):
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(got, want, tol * (1 + scale), 0.0, what)


def _cam_inputs(rng, b, ncam, hw=(64, 96)):
    """Camera inputs like ``add_camera_inputs``, with jittered intrinsics and
    augmentation transforms so that no matrix is trivial."""
    h, w = hw
    imgs = rng.uniform(0, 1, (b, ncam, h, w, 4)).astype(np.float32)
    # some below d_min; none at or above d_max = 50, which the gt binning
    # clamps onto the last bin's upper edge (see test_bin_depth_indices_identical)
    imgs[..., 3] = rng.uniform(1, 49.9, (b, ncam, h, w))
    intr = np.zeros((b, ncam, 3, 3), np.float32)
    intr[..., 0, 0] = w * rng.uniform(0.7, 0.9, (b, ncam))
    intr[..., 1, 1] = w * rng.uniform(0.7, 0.9, (b, ncam))
    intr[..., 0, 2] = w / 2 + rng.uniform(-3, 3, (b, ncam))
    intr[..., 1, 2] = h / 2 + rng.uniform(-3, 3, (b, ncam))
    intr[..., 2, 2] = 1.0
    yaw = rng.uniform(-np.pi, np.pi, (b, ncam))
    c, s = np.cos(yaw), np.sin(yaw)
    base = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rz = np.zeros((b, ncam, 3, 3))
    rz[..., 0, 0], rz[..., 0, 1], rz[..., 1, 0], rz[..., 1, 1] = c, -s, s, c
    rz[..., 2, 2] = 1.0
    rots = (rz @ base).astype(np.float32)
    a = rng.uniform(-0.2, 0.2, (b, ncam))
    post_rots = np.zeros((b, ncam, 3, 3), np.float32)
    post_rots[..., 0, 0] = post_rots[..., 1, 1] = 1 + a
    post_rots[..., 0, 1] = a / 3
    post_rots[..., 2, 2] = 1.0
    return {
        "imgs": imgs, "intrinsics": intr, "rots": rots,
        "trans": rng.uniform(-2, 2, (b, ncam, 3)).astype(np.float32),
        "post_rots": post_rots,
        "post_trans": rng.uniform(-4, 4, (b, ncam, 3)).astype(np.float32),
    }


def _torch_tree(tree):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()}


# --- host-side helpers ------------------------------------------------------


@pytest.mark.parametrize("mode", ["UD", "LID"])
def test_depth_bins_and_frustum_identical(mode):
    for args in ((2, 50, 8), (1, 60, 41), (4.5, 45.0, 80)):
        np.testing.assert_array_equal(lss.depth_discretization(*args, mode),
                                      jlss.depth_discretization(*args, mode))
    for final_dim, ds in (((64, 96), 8), ((256, 352), 8), ((256, 352), 16)):
        got = lss.create_frustum(final_dim, ds, (2, 50, 8), mode)
        want = jlss.create_frustum(final_dim, ds, (2, 50, 8), mode)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    for bounds in (([-140.8, 140.8, 0.4], [-40.0, 40.0, 0.4], [-10.0, 10.0, 20.0]),
                   ([-19.2, 19.2, 0.4], [-19.2, 19.2, 0.4], [-10, 10, 20.0])):
        for g, w in zip(lss.gen_dx_bx(*bounds), jlss.gen_dx_bx(*bounds)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("target", [False, True])
@pytest.mark.parametrize("mode", ["UD", "LID"])
def test_bin_depth_indices_identical(mode, target):
    """Bin indices and valid masks equal the JAX package's, out-of-range,
    infinite and NaN depths included, except where a depth's exact bin
    coordinate lies within BIN_MARGIN of a bin edge (as d_max's does in LID
    mode, where it is exactly the bin count, and three random depths' do):
    there f32 rounds to either side in either package, so the index may
    differ by one and the mask too."""
    rng = np.random.default_rng(0)
    depth = rng.uniform(-5, 70, (3, 40, 50)).astype(np.float32)
    depth.flat[:5] = [np.inf, -np.inf, np.nan, 2.0, 50.0]
    got = lss.bin_depth_indices(torch.from_numpy(depth), mode, 2, 50, 8, target)
    want = jlss.bin_depth_indices(jnp.asarray(depth), mode, 2, 50, 8, target)
    x = depth.astype(np.float64)
    with np.errstate(invalid="ignore"):
        if mode == "UD":
            exact = (x - 2) / 6.0
        else:
            exact = -0.5 + 0.5 * np.sqrt(1 + 8 * (x - 2) / (2 * 48 / 72))
        edge = np.isfinite(exact) & (np.abs(exact - np.round(exact)) < BIN_MARGIN)
    g, w = (got[0].numpy(), got[1].numpy()), (np.asarray(want[0]), np.asarray(want[1]))
    np.testing.assert_array_equal(g[0][~edge], w[0][~edge])
    np.testing.assert_array_equal(g[1][~edge], w[1][~edge])
    assert np.abs(g[0][edge].astype(int) - w[0][edge]).max(initial=0) <= 1
    assert got[0].dtype == torch.int32


def _geometry(rng, b, ncam, final_dim=(64, 96)):
    frustum = lss.create_frustum(final_dim, 8, (2, 50, 8), "LID")
    cam = _cam_inputs(rng, b, ncam, final_dim)
    keys = ("rots", "trans", "intrinsics", "post_rots", "post_trans")
    got = lss.get_geometry(torch.from_numpy(frustum),
                           *(torch.from_numpy(cam[k]) for k in keys)).numpy()
    want = np.asarray(jlss.get_geometry(jnp.asarray(frustum),
                                        *(jnp.asarray(cam[k]) for k in keys)))
    return got, want


def test_get_geometry_matches_jax():
    got, want = _geometry(np.random.default_rng(1), 2, 3)
    assert got.shape == want.shape == (2, 3, 8, 8, 12, 3)
    _rel_close(got, want, GEOM_TOL, "geometry")


def test_get_geometry_manual_point():
    """One frustum point unprojected by hand in float64."""
    rng = np.random.default_rng(2)
    frustum = lss.create_frustum((64, 96), 8, (2, 50, 8), "LID")
    cam = _cam_inputs(rng, 1, 1)
    keys = ("rots", "trans", "intrinsics", "post_rots", "post_trans")
    geom = lss.get_geometry(torch.from_numpy(frustum),
                            *(torch.from_numpy(cam[k]) for k in keys)).numpy()
    u, v, d = frustum[3, 2, 5].astype(np.float64)
    p = np.linalg.inv(cam["post_rots"][0, 0]) @ (
        np.array([u, v, d]) - cam["post_trans"][0, 0])
    p = np.array([p[0] * p[2], p[1] * p[2], p[2]])
    want = cam["rots"][0, 0] @ np.linalg.inv(cam["intrinsics"][0, 0]) @ p + \
        cam["trans"][0, 0]
    np.testing.assert_allclose(geom[0, 0, 3, 2, 5], want, rtol=1e-5, atol=1e-5)


def test_voxel_pooling_known_cells():
    """Two points in one cell, one in another, one out of range, and one at
    a negative fraction of a cell below the grid, which truncation toward
    zero puts in cell 0 (a floor would drop it)."""
    dx, bx, nx = lss.gen_dx_bx([-2, 2, 1], [-2, 2, 1], [-1, 1, 2])
    geom = np.array([[[-1.5, -1.5, 0.0], [-1.4, -1.6, 0.0], [0.5, 0.5, 0.0],
                      [9.0, 0.0, 0.0], [-2.5, -1.2, 0.5]]], np.float32)
    feats = np.ones((1, 5, 2), np.float32)
    feats[0, 4] = [10.0, 20.0]
    want = np.asarray(jlss.voxel_pooling(geom[:, None, None, None],
                                         jnp.asarray(feats[:, None, None, None]),
                                         jnp.asarray(dx), jnp.asarray(bx), nx))
    got = lss.voxel_pooling(torch.from_numpy(geom), torch.from_numpy(feats),
                            torch.from_numpy(dx), torch.from_numpy(bx - dx / 2.0),
                            nx).numpy()
    assert got.shape == (1, 4, 4, 2)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0].tolist() == [12.0, 22.0]  # two points + the -0.5 one
    assert got[0, 2, 2].tolist() == [1.0, 1.0]
    assert got.sum() == 36.0  # the out-of-range point is dropped


@pytest.mark.parametrize("nz", [1, 2])
def test_voxel_pooling_matches_jax(nz):
    """Random points over and around a 12 x 10 x nz grid, two samples; z
    slices concatenated on the channel axis."""
    rng = np.random.default_rng(3)
    dx, bx, nx = lss.gen_dx_bx([-2.4, 2.4, 0.4], [-2.0, 2.0, 0.4],
                               [-1.0, 1.0, 2.0 / nz])
    geom = np.stack([rng.uniform(-3, 3, (2, 3, 40)), rng.uniform(-2.5, 2.5, (2, 3, 40)),
                     rng.uniform(-1.5, 1.5, (2, 3, 40))], -1).astype(np.float32)
    feats = rng.normal(size=(2, 3, 40, 5)).astype(np.float32)
    want = np.asarray(jlss.voxel_pooling(jnp.asarray(geom), jnp.asarray(feats),
                                         jnp.asarray(dx), jnp.asarray(bx), nx))
    got = lss.voxel_pooling(torch.from_numpy(geom), torch.from_numpy(feats),
                            torch.from_numpy(dx), torch.from_numpy(bx - dx / 2.0),
                            nx).numpy()
    assert got.shape == want.shape == (2, 10, 12, 5 * nz)
    assert_close(got, want, TOL, TOL, "voxel_pooling")
    assert np.abs(want).sum() > 0


@pytest.mark.parametrize("src,dst", [((5, 7), (10, 14)), ((1, 7), (4, 28)),
                                     ((6, 1), (1, 3)), ((25, 88), (100, 352))])
def test_upsample_align_corners(src, dst):
    x = np.random.default_rng(4).normal(size=(2,) + src + (3,)).astype(np.float32)
    want = np.asarray(jtrunks.upsample_align_corners(jnp.asarray(x), *dst))
    got = trunks.upsample_align_corners(nhwc_to_nchw(x), *dst)
    lib = F.interpolate(nhwc_to_nchw(x), size=dst, mode="bilinear",
                        align_corners=True)
    assert_close(nchw_to_nhwc(lib), want, 1e-6, 1e-6, "F.interpolate vs JAX")
    assert_close(nchw_to_nhwc(got), want, 1e-6, 1e-6, "upsample")


@pytest.mark.parametrize("dst", [(5, 7), (8, 9), (3, 4), (2, 10), (7, 5)])
def test_pad_or_crop_to(dst):
    x = np.random.default_rng(5).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jtrunks.pad_or_crop_to(jnp.asarray(x), *dst))
    got = nchw_to_nhwc(trunks.pad_or_crop_to(nhwc_to_nchw(x), *dst))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (5, 1), (5, 2)])
def test_static_same_padding(kernel, stride):
    assert trunks.static_same_padding(kernel, stride) == tuple(
        tuple(p) for p in jtrunks.static_same_padding(kernel, stride))


# --- modules through the weight bridge --------------------------------------


def _module_case(jmod, tmod, args, seed=0, nchw=None, **kw):
    """flax variables of ``jmod`` (seeded numpy), loaded into ``tmod``; both
    applied to ``args`` (NHWC numpy for the JAX side; ``nchw`` marks the
    arguments the port takes as NCHW)."""
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    var = random_variables(jmod, *jargs, seed=seed, train=False, **kw)
    want = jax.jit(lambda v, *a: jmod.apply(v, *a, train=False, **kw))(
        var, *jargs)
    load_flax_variables(tmod, var)
    tmod.eval()
    nchw = nchw if nchw is not None else [True] * len(args)
    targs = [nhwc_to_nchw(a) if n else
             (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
             for a, n in zip(args, nchw)]
    with torch.no_grad():
        got = tmod(*targs)
    return got, want


@pytest.mark.parametrize("in_c,out_c,kernel,stride,expand", [
    (32, 16, 3, 1, 1),   # block0: no expansion, no skip
    (24, 24, 3, 1, 6),   # stride 1, in == out: the skip
    (16, 24, 3, 2, 6),   # stride 2, pad (0, 1)
    (40, 80, 5, 2, 6),   # k5 stride 2, pad (1, 2)
    (80, 112, 5, 1, 6),  # k5 stride 1, in != out
])
def test_mbconv_block(in_c, out_c, kernel, stride, expand):
    x = np.random.default_rng(6).normal(size=(2, 12, 18, in_c)).astype(np.float32)
    got, want = _module_case(
        jtrunks.MBConvBlock(in_c=in_c, out_c=out_c, kernel=kernel,
                            stride=stride, expand=expand),
        trunks.MBConvBlock(in_c, out_c, kernel, stride, expand), [x])
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "mbconv")


def test_efficientnet_b0_features():
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    got, want = _module_case(jtrunks.EfficientNetB0Features(),
                             trunks.EfficientNetB0Features(), [x])
    for g, w, c in zip(got, want, (40, 112, 320)):
        assert nchw_to_nhwc(g).shape == np.asarray(w).shape
        assert g.shape[1] == c
        _rel_close(nchw_to_nhwc(g), np.asarray(w), TOL, f"reduction {c}")


@pytest.mark.parametrize("scale,xhw,skiphw", [(2, (3, 5), (6, 10)),
                                              (2, (3, 5), (7, 9)),
                                              (4, (2, 6), (8, 24))])
def test_up_block(scale, xhw, skiphw):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2,) + xhw + (12,)).astype(np.float32)
    skip = rng.normal(size=(2,) + skiphw + (5,)).astype(np.float32)
    got, want = _module_case(jtrunks.UpBlock(out_c=8, scale=scale),
                             trunks.UpBlock(17, 8, scale=scale), [x, skip])
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "up block")


@pytest.mark.parametrize("stride,downsample", [(1, False), (2, True)])
def test_torch_basic_block(stride, downsample):
    x = np.random.default_rng(9).normal(size=(2, 10, 12, 16)).astype(np.float32)
    planes = 16 if not downsample else 24
    got, want = _module_case(
        jtrunks.TorchBasicBlock(planes, stride=stride, downsample=downsample),
        trunks.TorchBasicBlock(16, planes, stride, downsample), [x])
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "basic block")


@pytest.mark.parametrize("in_c,planes,stride,downsample", [
    (16, 8, 1, True),    # layer1_0: the projection at stride 1
    (32, 8, 1, False),   # the identity skip
    (32, 16, 2, True),   # layer2_0: stride 2 on conv2 and the projection
])
def test_torch_bottleneck(in_c, planes, stride, downsample):
    x = np.random.default_rng(12).normal(size=(2, 10, 12, in_c)).astype(np.float32)
    got, want = _module_case(
        jtrunks.TorchBottleneck(planes, stride=stride, downsample=downsample),
        trunks.TorchBottleneck(in_c, planes, stride, downsample), [x])
    assert nchw_to_nhwc(got).shape == np.asarray(want).shape
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "bottleneck")


def test_resnet101_trunk():
    """conv1 .. layer2: 512 channels at /8 of the input."""
    x = np.random.default_rng(13).uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    got, want = _module_case(jtrunks.ResNet101Trunk(), trunks.ResNet101Trunk(), [x])
    assert nchw_to_nhwc(got).shape == np.asarray(want).shape == (2, 4, 6, 512)
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "resnet101 trunk")


def _cam_encoder_case(gt, encoder_type):
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    onehot = None
    if gt:
        onehot = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (2, 8, 12))]
        onehot[0, 0, 0] = 0.0  # an out-of-range pixel
    jmod = jlss.CamEncoder(depth_bins=8, context_c=16, downsample=8,
                           encoder_type=encoder_type, use_gt_depth=gt)
    tmod = lss.CamEncoder(8, 16, 8, encoder_type=encoder_type, use_gt_depth=gt)
    (got, got_logits), (want, want_logits) = _module_case(
        jmod, tmod, [x, onehot], nchw=[True, False])
    assert got.shape == want.shape == (2, 8, 12, 8, 16)
    _rel_close(got.numpy(), np.asarray(want), TOL, "lifted")
    if gt:
        assert got_logits is None and want_logits is None
        assert tmod.depth_head is None
    else:
        _rel_close(got_logits.numpy(), np.asarray(want_logits), TOL, "logits")


@pytest.mark.parametrize("gt", [False, True], ids=["softmax", "gt_depth"])
def test_cam_encoder(gt):
    _cam_encoder_case(gt, "EfficientNet")


@pytest.mark.parametrize("gt", [False, True], ids=["softmax", "gt_depth"])
def test_cam_encoder_resnet101(gt):
    """``camera_encoder: Resnet101``: the truncated resnet's 512 channels at
    /8 straight into the 1x1 heads."""
    _cam_encoder_case(gt, "Resnet101")


def test_bev_encoder():
    x = np.random.default_rng(11).normal(size=(2, 24, 40, 16)).astype(np.float32)
    got, want = _module_case(jlss.BevEncoder(out_c=16), lss.BevEncoder(16, 16), [x])
    assert nchw_to_nhwc(got).shape == np.asarray(want).shape == (2, 24, 40, 16)
    _rel_close(nchw_to_nhwc(got), np.asarray(want), TOL, "bev encoder")


def _boundary_margin(geom, cfg):
    """Smallest distance, in cell widths, of any point to a cell boundary
    (float64 from the f32 points)."""
    grid = cfg["grid_conf"]
    dx, bx, _ = lss.gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
    u = (np.asarray(geom, np.float64) - (bx - dx / 2.0)) / dx
    return float(np.abs(u - np.round(u)).min())


@pytest.mark.parametrize("gt", [False, True], ids=["softmax", "gt_depth"])
def test_lss_camera_encoder(gt):
    cfg = dict(CAM_CFG, use_depth_gt=gt)
    cam = _cam_inputs(np.random.default_rng(18), 2, 2)
    jmod = jlss.LSSCameraEncoder(cfg=cfg)
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    var = random_variables(jmod, jcam, seed=3, train=False)
    want = np.asarray(jax.jit(lambda v, c: jmod.apply(v, c, False))(var, jcam))
    tmod = lss.LSSCameraEncoder(cfg).eval()
    load_flax_variables(tmod, var)
    marks = []
    with torch.no_grad():
        got = tmod(_torch_tree(cam), marks.append).numpy()
    assert marks == ["trunks+heads", "lift+voxel pooling", "BEV encoder"]
    assert got.shape == want.shape == (2, 96, 96, 16)
    frustum = lss.create_frustum((64, 96), 8, (2, 50, 8), "LID")
    keys = ("rots", "trans", "intrinsics", "post_rots", "post_trans")
    geom = lss.get_geometry(torch.from_numpy(frustum),
                            *(torch.from_numpy(cam[k]) for k in keys))
    assert _boundary_margin(geom, cfg) > CELL_MARGIN
    _rel_close(got, want, TOL, "lss encoder")


# --- the whole tiny camera model --------------------------------------------


def _camera_hypes(load, kind):
    """The tiny config with cameras: ``cam`` gives every agent type the
    camera modality alone (depth from the softmax head); ``lidar+cam`` gives
    the vehicles both (gt depth), as tests/test_camera.py builds it."""
    hypes = copy.deepcopy(load(TINY))
    args = hypes["model"]["args"]
    if kind == "cam":
        for t in ("vehicle", "rsu", "drone"):
            args[t]["modalities"] = ["cam"]
            args[t]["cam"] = dict(CAM_CFG, use_depth_gt=False)
    else:
        args["vehicle"]["modalities"] = ["lidar", "cam"]
        args["vehicle"]["cam"] = copy.deepcopy(CAM_CFG)
    return hypes


def _camera_batch(hypes, seed):
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(seed)
    scenes = []
    for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
               {"vehicle": 2, "rsu": 1, "drone": 0}):
        b, _ = jax_make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"],
                              pts_per_box=60, num_agents=na)
        jax_add_camera_inputs(b, layout, rng, img_hw=(64, 96), ncam=NCAM)
        scenes.append(b)
    return {k: ({kk: np.stack([s[k][kk] for s in scenes]) for kk in scenes[0][k]}
                if isinstance(scenes[0][k], dict)
                else np.stack([s[k] for s in scenes]))
            for k in scenes[0]}


def _jnp(batch):
    return jax.tree.map(jnp.asarray, batch)


def _frustum_margin(hypes, batch):
    """Smallest boundary margin (cell widths) of the frustum points of every
    camera agent type's inputs in ``batch``."""
    args = hypes["model"]["args"]
    margin = np.inf
    for t in ("vehicle", "rsu", "drone"):
        if "cam" not in args[t]["modalities"]:
            continue
        cfg = args[t]["cam"]
        cam = batch[f"cam_{t}"]
        frustum = lss.create_frustum(cfg["data_aug_conf"]["final_dim"],
                                     cfg["img_downsample"],
                                     cfg["grid_conf"]["ddiscr"],
                                     cfg["grid_conf"]["mode"])
        keys = ("rots", "trans", "intrinsics", "post_rots", "post_trans")
        geom = lss.get_geometry(torch.from_numpy(frustum), *(
            torch.from_numpy(cam[k].reshape((-1,) + cam[k].shape[2:]))
            for k in keys))
        margin = min(margin, _boundary_margin(geom, cfg))
    return margin


@pytest.fixture(scope="module", params=["cam", "lidar+cam"])
def camera_run(request, monkeypatch_module):
    kind = request.param
    hypes = _camera_hypes(jax_load_yaml, kind)
    batch = _camera_batch(hypes, seed=3)
    jmodels = {"f32": jax_build_model(hypes)}
    bf16 = copy.deepcopy(hypes)
    bf16["model"]["args"]["dtype"] = "bf16"
    jmodels["bf16"] = jax_build_model(bf16)
    var = random_variables(jmodels["f32"], _jnp(batch), seed=30, train=False)
    heads = var["params"]["heads"]
    heads["cls_head"]["kernel"] = heads["cls_head"]["kernel"] * np.float32(1e-3)
    heads["cls_head"]["bias"] = np.full_like(heads["cls_head"]["bias"],
                                             math.log(CONF / (1 - CONF)))
    # smaller box deltas keep decoded boxes near their anchors, as a trained
    # detector's are, so that the box filters leave candidates to the NMS
    heads["reg_head"]["kernel"] = heads["reg_head"]["kernel"] * np.float32(0.1)
    tmodel = build_model(_camera_hypes(load_yaml, kind), device="cpu")
    load_flax_variables(tmodel, var)
    cache = {}

    def jax_out(mode, dtype):
        """The JAX model's outputs under AIRV2X_CONV_KERNEL=mode (read at
        trace time) in the compute ``dtype``, computed once."""
        if (mode, dtype) not in cache:
            monkeypatch_module.setenv("AIRV2X_CONV_KERNEL", mode)
            jm = jmodels[dtype]
            out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
                var, _jnp(batch))
            cache[mode, dtype] = {k: np.asarray(v, np.float32)
                                  for k, v in out.items()}
        return cache[mode, dtype]

    return kind, hypes, jax_out, var, tmodel, batch


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_camera_scene_margin(camera_run):
    _, hypes, _, _, _, batch = camera_run
    assert _frustum_margin(hypes, batch) > CELL_MARGIN


def test_camera_model_builds_no_pillar_encoder_without_lidar(camera_run):
    kind, _, _, _, tmodel, _ = camera_run
    names = {n for n, _ in tmodel.encoder.named_children()}
    if kind == "cam":
        assert names == {"vehicle_lss", "rsu_lss", "drone_lss"}
    else:
        assert names == {"vehicle_pillar_vfe", "vehicle_lss", "rsu_pillar_vfe",
                         "drone_pillar_vfe"}


def _keep_set(psm, rm, obj, anchors, lr, decode, sigmoid, sort):
    """The decoded keep mask indexed by anchor (the pool order may swap
    scores that tie to within the two frameworks' rounding)."""
    det = decode(psm, rm, obj, anchors, lr)
    objness = sigmoid(obj).reshape(-1)
    keep = np.zeros(objness.shape[0], bool)
    keep[np.asarray(sort(objness))[:2 * TOP_K]] = np.asarray(det.mask)
    return keep, det


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_camera_model_matches_jax(camera_run, monkeypatch, mode):
    """psm / rm / obj to 1e-4 x (1 + scale) and the comm rate, then
    decode_detections on each side: the same keep set, away from the NMS
    threshold. Both packages under ``AIRV2X_CONV_KERNEL=mode`` (the JAX
    Pallas conv in interpret mode, the port's K4 plain version)."""
    kind, hypes, jax_out, _, tmodel, batch = camera_run
    want = jax_out(mode, "f32")
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)  # read at every forward
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        assert got[k].shape == want[k].shape
        assert want[k].shape[:3] == (2, 48, 48)
        _rel_close(got[k].numpy(), want[k], TOL_MODEL, f"{kind} {k}")
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                    abs=1e-6)

    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], np.float32)
    kw = dict(num_class=hypes["num_class"],
              obj_threshold=hypes["postprocess"]["target_args"]["obj_threshold"],
              nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=TOP_K)
    thr = kw["obj_threshold"]
    for b in range(2):
        jkeep, _ = _keep_set(
            *(jnp.asarray(want[k][b]) for k in ("psm", "rm", "obj")),
            jnp.asarray(anchors), jnp.asarray(lr),
            lambda *a: jax_decode(*a[:4], jnp.eye(4), a[4], **kw),
            jax.nn.sigmoid,
            lambda o: jax.lax.top_k(jnp.where(o > thr, o, -jnp.inf), 2 * TOP_K)[1])
        tkeep, tdet = _keep_set(
            *(got[k][b] for k in ("psm", "rm", "obj")),
            torch.from_numpy(anchors), torch.from_numpy(lr),
            lambda *a: decode_detections(*a[:4], torch.eye(4), a[4], **kw),
            torch.sigmoid,
            lambda o: torch.sort(torch.where(o > thr, o, -torch.inf),
                                 descending=True, stable=True)[1].numpy())
        # the pairs of candidates that enter the NMS (an invalid one neither
        # keeps nor suppresses) stay clear of its threshold
        live = ((tdet.scores > 0) & geo.keep_reasonable_boxes(
            tdet.corners, z_min=float(lr[2]), z_max=float(lr[5]))).numpy()
        corners = tdet.corners[:, :4, :2].contiguous()
        iou = quad_iou_plain(corners, corners).numpy()
        i, j = np.triu_indices(len(iou), k=1)
        gap = np.abs(iou[i, j][live[i] & live[j]] - kw["nms_thresh"]).min()
        assert gap > 1e-4, f"an IoU lies {gap:.2e} from the NMS threshold"
        np.testing.assert_array_equal(tkeep, jkeep)
        assert 0 < jkeep.sum() < TOP_K


@pytest.mark.parametrize("mode", ["auto", "pallas"])
def test_camera_model_bf16_matches_jax_bf16(camera_run, monkeypatch, mode):
    """The serving model cast to bf16 (``cast_weights_``) against the JAX
    package computing in bf16 over f32 parameters: within BF16_TOL of it,
    and no further from the exact (f32) outputs than JAX's own bf16 lies
    from them, with 50% room."""
    kind, _, jax_out, var, _, batch = camera_run
    want, exact = jax_out(mode, "bf16"), jax_out(mode, "f32")
    tmodel = build_model(_camera_hypes(load_yaml, kind), device="cpu")
    load_flax_variables(tmodel, var)
    cast_weights_(tmodel, torch.bfloat16)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        g = got[k].float().numpy()
        scale = np.abs(want[k]).max()
        assert scale > 1
        err = np.abs(g - want[k]).max()
        assert err <= BF16_TOL * (1 + scale), (kind, k, err, scale)
        own = np.abs(g - exact[k]).max()
        ref = np.abs(want[k] - exact[k]).max()
        assert own <= 1.5 * ref, (kind, k, own, ref)
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                    abs=1e-6)


def test_cast_weights_keeps_batchnorms_f32():
    """Every BatchNorm-type module (the pillar encoder's MaskedBatchNorm,
    the trunks' and the backbone's BatchNorm2d) and the frustum constants
    stay f32 under the bf16 serving cast; convs and dense layers go bf16."""
    model = build_model(_camera_hypes(load_yaml, "lidar+cam"), device="cpu")
    cast_weights_(model, torch.bfloat16)
    norms = [m for m in model.modules()
             if isinstance(m, (torch.nn.BatchNorm2d, MaskedBatchNorm))]
    assert any(isinstance(m, MaskedBatchNorm) for m in norms)
    assert len(norms) > 80
    for m in norms:
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32, (m, name)
    lss_mod = model.encoder.vehicle_lss
    for t in (lss_mod.frustum, lss_mod.dx, lss_mod.lo):
        assert t.dtype == torch.float32
    assert model.encoder.vehicle_pillar_vfe.dense.weight.dtype == torch.bfloat16
    assert lss_mod.camencode.trunk.block3.depthwise_conv.weight.dtype == \
        torch.bfloat16
    assert set(model.state_dict()) == set(
        build_model(_camera_hypes(load_yaml, "lidar+cam"),
                    device="cpu").state_dict())


def test_initialisers_cover_the_camera_modules():
    """``init_flax_like_`` draws every trunk / LSS kernel with flax's fan-in
    (a depthwise kernel's fan-in is its k * k taps) and resets every BN;
    ``init_random_`` redraws every parameter and statistic."""
    from airv2x_tpu_torch.utils.weights import init_flax_like_, init_random_

    enc = lss.LSSCameraEncoder(dict(CAM_CFG, use_depth_gt=False)).eval()
    before = {k: v.clone() for k, v in enc.state_dict().items()}
    init_flax_like_(enc, seed=0)
    trunk = enc.camencode.trunk
    dw = trunk.block13.depthwise_conv.weight.detach()  # (1152, 1, 5, 5)
    assert dw.shape == (1152, 1, 5, 5)
    # lecun_normal truncated at two std keeps 0.8796^2 of the variance
    assert float(dw.std()) == pytest.approx(math.sqrt(1 / 25), rel=0.05)
    assert float(trunk.block13.project_conv.weight.detach().std()) == pytest.approx(
        math.sqrt(1 / 1152), rel=0.05)
    for m in enc.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            assert bool((m.weight == 1).all()) and bool((m.running_var == 1).all())
    init_random_(enc, seed=1)
    after = enc.state_dict()
    changed = [k for k in before if not k.endswith("num_batches_tracked")
               and not torch.equal(before[k], after[k])]
    assert len(changed) == len(before) - sum(
        k.endswith("num_batches_tracked") for k in before)
