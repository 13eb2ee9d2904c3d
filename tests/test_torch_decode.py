"""The PyTorch port's decode path against the JAX package: K2's plain version
against the Pallas IoU kernel in interpret mode, box decode and geometry,
rotated NMS and the whole detection decode (identical keep masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.ops import geometry as jgeo
from airv2x_tpu.ops.boxes import decode_boxes as jax_decode_boxes
from airv2x_tpu.ops.nms import rotated_nms as jax_rotated_nms
from airv2x_tpu.ops.pallas_iou import pairwise_quad_iou_interpret
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.ops.boxes import decode_boxes
from airv2x_tpu_torch.ops.nms import rotated_nms
from airv2x_tpu_torch.ops.quad_iou import (
    TILE, _margin, _quad_terms, _separated, iou_blocks, quad_iou,
    quad_iou_plain)
from tests.torch_port_helpers import assert_close

IOU_TOL = 2e-5  # as tests/test_pallas_iou.py
TOL = 1e-5
NMS_THRESH = 0.15


def _boxes(rng, n, spread=60.0, cluster=0):
    """hwl boxes; the first ``cluster`` rows jittered around a few centres."""
    b = np.stack([
        rng.uniform(-spread, spread, n), rng.uniform(-spread / 2, spread / 2, n),
        rng.uniform(-1.2, -0.8, n), rng.uniform(1.4, 1.8, n),
        rng.uniform(1.5, 1.9, n), rng.uniform(3.5, 4.5, n),
        rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    if cluster:
        centres = b[rng.integers(0, 8, cluster), :2]
        b[:cluster, :2] = centres + rng.normal(0, 0.8, (cluster, 2))
    return b


def _quads(boxes):
    return np.array(jgeo.boxes_to_corners_bev(jnp.asarray(boxes), order="hwl"))


@pytest.mark.parametrize("triangular", [False, True])
def test_k2_plain_matches_pallas_interpret(triangular):
    q = _quads(_boxes(np.random.default_rng(0), 256, cluster=96))
    tile = 64 if triangular else 128
    want = np.asarray(pairwise_quad_iou_interpret(
        jnp.asarray(q), jnp.asarray(q), tile, tile, triangular=triangular))
    got = quad_iou(torch.from_numpy(q), torch.from_numpy(q),
                   triangular=triangular).numpy()
    if triangular:
        iu = np.triu_indices(256, k=1)
        got, want = got[iu], want[iu]
    assert_close(got, want, IOU_TOL, 0, "iou")
    assert (want > 0.01).sum() > 20  # the clusters overlap


def test_k2_plain_exact_cases():
    sq = np.array([[0, 0], [4, 0], [4, 2], [0, 2]], np.float32) + 100.0
    shifted = sq + np.array([4, 0], np.float32)  # shares the edge x = 104
    rot = np.array([[0, 0], [2, 2], [0, 4], [-2, 2]], np.float32) - 70.0
    q = torch.from_numpy(np.stack([sq, sq, shifted, rot, rot]))
    iou = quad_iou_plain(q, q).numpy()
    assert iou[0, 1] == pytest.approx(1.0, abs=1e-6)
    assert iou[3, 4] == pytest.approx(1.0, abs=1e-6)
    assert abs(iou[0, 2]) <= 1e-6 and abs(iou[1, 2]) <= 1e-6
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-6)


def test_decode_boxes():
    rng = np.random.default_rng(1)
    anchors = _boxes(rng, 50)
    deltas = rng.normal(0, 0.3, (50, 7)).astype(np.float32)
    want = np.asarray(jax_decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors)))
    got = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors))
    assert_close(got.numpy(), want, TOL, TOL, "decode_boxes")


def _rigid(rng):
    yaw = rng.uniform(-np.pi, np.pi)
    t = np.eye(4, dtype=np.float32)
    t[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    t[:3, 3] = rng.uniform(-5, 5, 3)
    return t


def test_geometry_ops():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 40, spread=150.0)
    boxes[:5, 3:6] *= 3.0  # over-large boxes
    boxes[5:8, 2] = -4.0  # abnormal z
    jb, tb = jnp.asarray(boxes), torch.from_numpy(boxes)
    for order in ("hwl", "lwh"):
        np.testing.assert_array_equal(
            geo.boxes_to_lwh_order(tb, order).numpy(),
            np.asarray(jgeo.boxes_to_lwh_order(jb, order)))
    pts = rng.normal(0, 5, (40, 8, 3)).astype(np.float32)
    assert_close(geo.rotate_points_z(torch.from_numpy(pts), tb[:, 6]).numpy(),
                 np.asarray(jgeo.rotate_points_z(jnp.asarray(pts), jb[:, 6])),
                 TOL, TOL, "rotate")
    corners = {}
    for order in ("hwl", "lwh"):
        c = geo.boxes_to_corners_3d(tb, order)
        assert_close(c.numpy(), np.asarray(jgeo.boxes_to_corners_3d(jb, order)),
                     TOL, TOL, order)
        corners[order] = c
    tr = _rigid(rng)
    proj = geo.project_corners(corners["hwl"], torch.from_numpy(tr))
    jproj = jgeo.project_corners(jgeo.boxes_to_corners_3d(jb, "hwl"),
                                 jnp.asarray(tr))
    assert_close(proj.numpy(), np.asarray(jproj), TOL, TOL, "project")
    lr = [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0]
    np.testing.assert_array_equal(
        geo.keep_reasonable_boxes(proj, z_min=-3.0, z_max=1.0).numpy(),
        np.asarray(jgeo.keep_reasonable_boxes(jproj, z_min=-3.0, z_max=1.0)))
    in_range = geo.mask_boxes_in_range_bev(proj, lr).numpy()
    np.testing.assert_array_equal(
        in_range, np.asarray(jgeo.mask_boxes_in_range_bev(jproj, jnp.asarray(lr))))
    assert in_range.any() and not in_range.all()


def _assert_no_iou_near(q_sorted, thresh, k):
    iou = quad_iou_plain(q_sorted[:k], q_sorted[:k]).numpy()
    iu = np.triu_indices(len(iou), k=1)
    gap = np.abs(iou[iu] - thresh).min()
    assert gap > 1e-4, f"an IoU lies {gap:.2e} from the NMS threshold"


def test_rotated_nms_matches_jax():
    rng = np.random.default_rng(3)
    n, k = 400, 256
    q = _quads(_boxes(rng, n, cluster=300))
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    valid = rng.uniform(size=n) > 0.15
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    _assert_no_iou_near(torch.from_numpy(q[order]), NMS_THRESH, k)
    want = np.asarray(jax_rotated_nms(jnp.asarray(q), jnp.asarray(scores),
                                      jnp.asarray(valid), NMS_THRESH, top_k=k))
    keep, passes = rotated_nms(torch.from_numpy(q), torch.from_numpy(scores),
                               torch.from_numpy(valid), NMS_THRESH, top_k=k)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < want.sum() < valid.sum() and passes >= 2


def test_decode_detections_matches_jax():
    rng = np.random.default_rng(4)
    aa = dict(W=48, H=40, l=3.9, w=1.6, h=1.56, r=[0, 90], vw=0.4, vh=0.4,
              cav_lidar_range=[-9.6, -8.0, -3.0, 9.6, 8.0, 1.0],
              feature_stride=2)
    anchors = generate_anchor_grid(aa)  # (20, 24, 2, 7)
    h, w, a = anchors.shape[:3]
    num_class, top_k = 7, 128
    # logits on a 0.01 grid: ties are common and other scores differ by far
    # more than the two frameworks' rounding
    obj = np.round(rng.normal(-1.0, 1.5, (h, w, a)), 2).astype(np.float32)
    psm = rng.normal(0, 1, (h, w, a * num_class)).astype(np.float32)
    rm = rng.normal(0, 0.1, (h, w, 7 * a)).astype(np.float32)
    tr = _rigid(rng)
    lr = np.asarray(aa["cav_lidar_range"], np.float32)
    kw = dict(num_class=num_class, obj_threshold=0.2, nms_thresh=NMS_THRESH,
              top_k=top_k)
    want = jax_decode(jnp.asarray(psm), jnp.asarray(rm), jnp.asarray(obj),
                      jnp.asarray(anchors), jnp.asarray(tr), jnp.asarray(lr), **kw)
    got = decode_detections(*(torch.from_numpy(v) for v in
                              (psm, rm, obj, anchors, tr, lr)), **kw)
    assert_close(got.boxes.numpy(), np.asarray(want.boxes), TOL, TOL, "boxes")
    assert_close(got.corners.numpy(), np.asarray(want.corners), 1e-4, TOL,
                 "corners")
    assert_close(got.scores.numpy(), np.asarray(want.scores), 1e-6, 0, "scores")
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    _assert_no_iou_near(got.corners[:, :4, :2].contiguous(), NMS_THRESH,
                        2 * top_k)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert 0 < int(got.mask.sum()) < top_k


def _rand_quads(rng, n, spread=(140.0, 40.0)):
    """n box quads (3.5-4.5 x 1.5-1.9 m, any yaw, either winding) with
    centres uniform over +-spread: the BEV range of the flagship."""
    ctr = rng.uniform(-1, 1, (n, 2)) * np.asarray(spread)
    lw = np.stack([rng.uniform(3.5, 4.5, n), rng.uniform(1.5, 1.9, n)], -1)
    tmpl = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) * 0.5
    local = tmpl[None] * lw[:, None]
    yaw = rng.uniform(-np.pi, np.pi, n)
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    q = np.stack([c * local[..., 0] - s * local[..., 1] + ctr[:, None, 0],
                  s * local[..., 0] + c * local[..., 1] + ctr[:, None, 1]], -1)
    flip = rng.uniform(size=n) < 0.5
    q[flip] = q[flip, ::-1]  # clockwise winding
    return q.astype(np.float32)


def _place_right_of(a, b, gap):
    """b moved along x so that its box starts ``gap`` right of a's."""
    shift = a[:, :, 0].max(1) - b[:, :, 0].min(1) + gap
    out = b.copy()
    out[:, :, 0] += shift[:, None].astype(np.float32)
    return out


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1),
       mode=st.sampled_from(["spread", "past_margin", "near_parallel",
                             "shared_edge"]))
def test_k2_separated_pairs_have_zero_iou(seed, mode):
    """Every pair the prefilter rejects has plain IoU exactly 0.0: random
    quads over the 140 m BEV range, pairs placed just past the margin,
    near-parallel edges a hair apart; quads sharing an edge are never
    rejected."""
    rng = np.random.default_rng(seed)
    a = _rand_quads(rng, 48)
    if mode == "spread":
        c = torch.from_numpy(a)
        sep = _separated(c, c)
        assert bool((quad_iou_plain(c, c)[sep] == 0).all())
        return
    if mode == "past_margin":
        b0 = _rand_quads(rng, 48)
        margin = _margin(_quad_terms(torch.from_numpy(a)),
                         _quad_terms(torch.from_numpy(b0))).numpy()
        b = _place_right_of(a, b0, margin * rng.uniform(1.0, 1.5, 48))
    elif mode == "near_parallel":  # a copy turned 1e-5 rad, a hair away
        ang = rng.uniform(-1e-5, 1e-5, 48)[:, None]
        ctr = a.mean(1, keepdims=True)
        d = (a - ctr).astype(np.float64)
        rot = np.stack([np.cos(ang) * d[..., 0] - np.sin(ang) * d[..., 1],
                        np.sin(ang) * d[..., 0] + np.cos(ang) * d[..., 1]], -1)
        edge = a[:, 1] - a[:, 0]  # shift across edge 0 by its length + 0-1 cm
        b = (rot + ctr + edge[:, None] * (1.0 + rng.uniform(0, 2.5e-3, (48, 1, 1)))
             ).astype(np.float32)
    else:  # shared_edge: b is a moved by one of its edges
        b = (a + (a[:, 1] - a[:, 0])[:, None]).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    sep = torch.diagonal(_separated(ta, tb))
    iou = torch.diagonal(quad_iou_plain(ta, tb))
    assert bool((iou[sep] == 0).all()), iou[sep]
    if mode == "past_margin":
        assert float(sep.float().mean()) > 0.9
    if mode == "shared_edge":
        assert not bool(sep.any())
        # the translated corners round at 140 m: a sliver of ~1e-6 may stay
        assert float(iou.abs().max()) <= IOU_TOL


def test_k2_separated_never_rejects_nan_or_degenerate_rows():
    rng = np.random.default_rng(16)
    q = _rand_quads(rng, 32)
    q[3, 2, 0] = np.nan
    q[4] = np.nan
    q[5, 1, 1] = np.inf
    q[6] = q[6, :1]  # all four corners at one point: no area
    q[7, 2] = q[7, 1]  # a repeated corner
    sep = _separated(torch.from_numpy(q), torch.from_numpy(q))
    for r in (3, 4, 5, 6, 7):
        assert not bool(sep[r].any()) and not bool(sep[:, r].any())
    assert bool(sep.any())  # the rest are spread over the range


def test_k2_degenerate_quads_have_iou_zero():
    """A quad of (nearly) zero area: zero-width boxes, as random weights
    decode them, a point and a sliver. The clip would weigh every edge of
    the other quad as collinear and report an IoU near 1 with any quad; the
    plain version gives 0. (The JAX package's XLA IoU is no reference
    there: it returns up to ~1e9 for the point.) The other pairs still
    match the Pallas kernel."""
    rng = np.random.default_rng(17)
    q = _rand_quads(rng, 24)
    q[0, 2], q[0, 3] = q[0, 1], q[0, 0]  # zero width, four distinct points
    q[1] = q[1, :1]  # a point
    q[2, 3], q[2, 2] = q[2, 0] + 3e-6, q[2, 1] + 3e-6  # a 3e-6 m sliver
    q[3] = q[0] + np.float32(5.0)  # a zero-width box far from the first
    got = quad_iou_plain(torch.from_numpy(q), torch.from_numpy(q)).numpy()
    want = np.asarray(pairwise_quad_iou_interpret(
        jnp.asarray(q), jnp.asarray(q), tile_i=8, tile_j=8))
    for r in range(4):
        assert (got[r] == 0).all() and (got[:, r] == 0).all(), got[r]
    assert_close(got[4:, 4:], want[4:, 4:], IOU_TOL, 0, "the other quads")


@pytest.mark.parametrize("n,m", [(512, 512), (300, 200), (200, 300), (1, 1),
                                 (33, 65), (64, 64), (31, 1)])
@pytest.mark.parametrize("triangular", [False, True], ids=["full", "tri"])
def test_k2_block_map_covers_every_pair_once(n, m, triangular):
    """The kernel's block -> tile map (a Python mirror): every (i, j) of the
    output is written by exactly one block, and every i < j lies in a tile
    that is computed, not zero-filled."""
    hits = np.zeros((n, m), np.int32)
    computed = np.zeros((n, m), bool)
    t = TILE
    for comp, zero in iou_blocks(n, m, triangular, t):
        for tile, is_comp in ((comp, True), (zero, False)):
            if tile is None:
                continue
            sl = (slice(tile[0] * t, tile[0] * t + t),
                  slice(tile[1] * t, tile[1] * t + t))
            hits[sl] += 1
            computed[sl] |= is_comp
    assert hits.min() == 1 and hits.max() == 1
    iu = np.triu_indices(n, 1, m)
    assert computed[iu].all()
    if not triangular:
        assert computed.all()

