"""Training targets of the PyTorch port against the JAX package: box
encoding, the standup geometry, anchor assignment and ``make_batch`` on the
tiny config's scenes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.data.synthetic import rasterize_seg_labels as jax_rasterize
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops import anchors as jax_anchors
from airv2x_tpu.ops import geometry as jax_geo
from airv2x_tpu.ops.boxes import encode_boxes as jax_encode
from airv2x_tpu_torch.data.synthetic import make_batch, rasterize_seg_labels
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.ops import anchors, geometry
from airv2x_tpu_torch.ops.boxes import decode_boxes, encode_boxes
from tests.torch_port_helpers import TINY, assert_close

# the scenes' seeds: on each, no anchor IoU lies within IOU_GAP of a
# threshold and every gt's best anchor wins by IOU_GAP or ties exactly
# (checked below), so one ulp of the IoU cannot move a label
SEEDS = (11, 110, 114)
IOU_GAP = 1e-6


def _boxes(rng, n):
    return np.stack([
        rng.uniform(-15, 15, n), rng.uniform(-15, 15, n), rng.uniform(-1.2, -0.8, n),
        rng.uniform(1.4, 1.8, n), rng.uniform(1.5, 1.9, n), rng.uniform(3.5, 4.5, n),
        rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    hypes = jax_load_yaml(TINY)
    grid = jax_anchors.generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    standup = jax_anchors.anchor_standup_boxes(grid)
    return hypes, grid, standup


def _scene_kw(hypes):
    return dict(num_objects=6, points_per_agent=1024, pts_per_box=60,
                lidar_range=hypes["preprocess"]["cav_lidar_range"],
                max_boxes=hypes["postprocess"]["max_num"])


def test_encode_boxes_matches_jax_and_inverts_decode():
    rng = np.random.default_rng(0)
    gt, anc = _boxes(rng, 64), _boxes(rng, 64)
    got = encode_boxes(torch.from_numpy(gt), torch.from_numpy(anc))
    assert_close(got.numpy(), np.asarray(jax_encode(jnp.asarray(gt), jnp.asarray(anc))),
                 1e-6, 1e-6, "encode")
    back = decode_boxes(got, torch.from_numpy(anc))
    assert_close(back.numpy(), gt, 1e-5, 1e-5, "decode(encode)")


def test_standup_geometry_matches_jax():
    """Corners, standup boxes and the +1-convention IoU, bit for bit on the
    corners and to 1e-7 on the IoU."""
    rng = np.random.default_rng(1)
    b1, b2 = _boxes(rng, 40), _boxes(rng, 30)
    b2[:5] = b1[:5]  # identical boxes: IoU 1
    c1 = geometry.boxes_to_corners_bev(torch.from_numpy(b1))
    jc1 = jax_geo.boxes_to_corners_bev(jnp.asarray(b1))
    assert_close(c1.numpy(), np.asarray(jc1), 1e-6, 0, "corners")
    s1 = geometry.corners_to_standup_2d(c1)
    s2 = geometry.corners_to_standup_2d(geometry.boxes_to_corners_bev(torch.from_numpy(b2)))
    js1 = jax_geo.corners_to_standup_2d(jc1)
    js2 = jax_geo.corners_to_standup_2d(jax_geo.boxes_to_corners_bev(jnp.asarray(b2)))
    assert_close(s1.numpy(), np.asarray(js1), 1e-6, 0, "standup")
    iou = geometry.aligned_iou_2d(s1, s2).numpy()
    assert_close(iou, np.asarray(jax_geo.aligned_iou_2d(js1, js2)), 1e-7, 0, "iou")
    assert np.allclose(np.diagonal(iou[:5, :5]), 1.0)


def test_anchor_standup_boxes_bit_identical(setup):
    _, grid, standup = setup
    got = anchors.anchor_standup_boxes(anchors.generate_anchor_grid(
        jax_load_yaml(TINY)["postprocess"]["anchor_args"]))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, standup)


@pytest.mark.parametrize("seed", SEEDS)
def test_make_batch_and_assign_targets_match_jax(setup, seed):
    """The same seed gives bit-identical scene arrays and seg labels; the
    anchor labels (positives, negatives, classes) are equal exactly and the
    regression targets to 1e-6 (XLA's log and division round apart from
    torch's by an ulp)."""
    hypes, grid, standup = setup
    layout_args = hypes["model"]["args"]
    ta = hypes["postprocess"]["target_args"]
    kw = dict(anchors=grid, anchor_standup=standup, target_args=ta, seg_hw=96,
              **_scene_kw(hypes))
    want, gt = jax_make_batch(np.random.default_rng(seed),
                              JaxSlotLayout.from_args(layout_args), 2, **kw)
    got, got_gt = make_batch(np.random.default_rng(seed),
                             SlotLayout.from_args(layout_args), 2, device="cpu",
                             **kw)

    # the margins that make exact labels a fair demand
    for s in range(2):
        m = gt["mask"][s]
        gs = jax_geo.corners_to_standup_2d(
            jax_geo.boxes_to_corners_bev(jnp.asarray(gt["boxes"][s][m])))
        iou = np.asarray(jax_geo.aligned_iou_2d(jnp.asarray(standup), gs))
        for thr in (ta["pos_threshold"], ta["neg_threshold"]):
            assert np.abs(iou - thr).min() > IOU_GAP
        best = iou.max(0)
        near = (iou > best - IOU_GAP) & (iou != best)
        assert not near.any(), "a best anchor wins by less than IOU_GAP"

    assert set(got) == set(want)
    for k in want:
        if k == "labels":
            continue
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in gt:
        np.testing.assert_array_equal(got_gt[k], gt[k], err_msg=k)
    assert set(got["labels"]) == set(want["labels"])
    for k in ("pos_equal_one", "neg_equal_one", "class_ids",
              "dynamic_seg_label", "static_seg_label"):
        assert got["labels"][k].dtype == want["labels"][k].dtype, k
        np.testing.assert_array_equal(got["labels"][k], want["labels"][k], err_msg=k)
    assert_close(got["labels"]["targets"], want["labels"]["targets"], 1e-6, 1e-6,
                 "targets")
    assert want["labels"]["pos_equal_one"].sum() > 0


def test_assign_targets_rules_on_crafted_gts(setup):
    """Forced positives (a gt under pos_threshold still gets its best
    anchor), two gts sharing anchors (the lowest-index threshold match
    wins), negatives that keep threshold positives, no valid gt (every
    anchor negative), against JAX."""
    hypes, grid, standup = setup
    ta = hypes["postprocess"]["target_args"]
    g = np.zeros((8, 7), np.float32)
    centre = grid[20, 30, 0]
    g[0] = centre  # an anchor itself: IoU 1 at its anchor
    g[1] = centre + np.array([0.05, 0, 0, 0, 0, 0, 0], np.float32)  # overlaps g[0]
    g[2] = grid[5, 5, 1] * np.array([1, 1, 1, 1, 0.6, 0.6, 1], np.float32)  # small
    cls = np.array([3, 5, 2, 0, 0, 0, 0, 0], np.int32)
    for mask in (np.arange(8) < 3, np.zeros(8, bool)):
        want = jax_anchors.assign_targets(
            jnp.asarray(g), jnp.asarray(mask), jnp.asarray(cls), jnp.asarray(grid),
            jnp.asarray(standup), pos_threshold=ta["pos_threshold"],
            neg_threshold=ta["neg_threshold"])
        got = anchors.assign_targets(
            torch.from_numpy(g), torch.from_numpy(mask), torch.from_numpy(cls),
            torch.from_numpy(grid), torch.from_numpy(standup),
            pos_threshold=ta["pos_threshold"], neg_threshold=ta["neg_threshold"])
        for field in ("pos_equal_one", "neg_equal_one", "cls_labels"):
            np.testing.assert_array_equal(getattr(got, field).numpy(),
                                          np.asarray(getattr(want, field)), field)
        assert_close(got.targets.numpy(), np.asarray(want.targets), 1e-6, 1e-6,
                     "targets")
        if mask.any():
            pos = got.pos_equal_one.numpy()
            assert pos[5, 5].any(), "the small gt's forced positive"
            assert got.cls_labels.numpy()[20, 30, 0] == 3, "lowest-index gt wins"
        else:
            assert got.neg_equal_one.numpy().all()


def test_rasterize_seg_labels_matches_jax():
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 10) * np.array([0.4, 0.4, 1, 1, 1, 1, 1], np.float32)
    mask = np.arange(10) < 7
    cls = rng.integers(1, 7, 10).astype(np.int32)
    got = rasterize_seg_labels(boxes, mask, cls, 64, 0.25)
    np.testing.assert_array_equal(got, jax_rasterize(boxes, mask, cls, 64, 0.25))
    assert (got > 0).any()
    jax.clear_caches()
