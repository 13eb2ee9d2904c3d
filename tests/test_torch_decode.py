"""The PyTorch port's decode path against the JAX package: K2's plain version
against the Pallas IoU kernel in interpret mode, box decode and geometry,
rotated NMS and the whole detection decode (identical keep masks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain
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
