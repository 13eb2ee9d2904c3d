"""The whole slice: the tiny Airv2xWhere2comm, initialised in JAX and loaded
into the PyTorch port through the weight bridge, on the same make_scene
batch; then decode_detections on each side's outputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.where2comm import gaussian_smooth
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import TINY, assert_close, jnp_tree, random_variables

# whole-model outputs pass through ~40 conv layers: f32 sums in another order
TOL = 1e-4
TOP_K = 256
# SAME-padded 5x5 gaussian of sigma 1 sums to (a_x * a_y) / (2 pi), where
# a = 1.7418 on the map's edge, 2.3484 one pixel in and 2.4838 further in.
# A nearly constant confidence s with s * 1.7418 * 2.4838 / (2 pi) < 0.01 <
# s * 2.3484**2 / (2 pi) masks out exactly the one-pixel border ring.
CONF = 0.012863


@pytest.fixture(scope="module")
def slice_run():
    hypes = jax_load_yaml(TINY)
    jmodel = jax_build_model(hypes)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(0)
    scenes = [
        jax_make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                       lidar_range=hypes["preprocess"]["cav_lidar_range"],
                       pts_per_box=60, num_agents=na)[0]
        for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
                   {"vehicle": 2, "rsu": 1, "drone": 0})
    ]
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    var = random_variables(jmodel, jnp_tree(batch), seed=21, train=False)
    # a near-constant single-agent confidence (see CONF) so that the comm
    # mask is decided far from the 0.01 threshold on both sides
    cls = var["params"]["heads"]["cls_head"]
    cls["kernel"] = cls["kernel"] * np.float32(1e-3)
    cls["bias"] = np.full_like(cls["bias"], math.log(CONF / (1 - CONF)))
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        var, jnp_tree(batch))
    want = {k: np.asarray(v) for k, v in want.items()}

    tmodel = build_model(load_yaml(TINY), device="cpu")
    load_flax_variables(tmodel, var)
    tbatch = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        x = tmodel.encode(tbatch)
        psm_single = tmodel.single_psm(x)
        got = tmodel.fuse(x, psm_single, tbatch["agent_mask"])
    return hypes, batch, want, got, psm_single


def test_single_agent_confidence_far_from_threshold(slice_run):
    _, _, _, _, psm_single = slice_run
    conf = gaussian_smooth(torch.sigmoid(psm_single.double()).amax(1), 5, 1.0)
    gap = float((conf - 0.01).abs().min())
    assert gap > 1e-4, f"a smoothed confidence lies {gap:.2e} from 0.01"
    below = conf <= 0.01
    assert below[:, 0].all() and not below[:, 1:-1, 1:-1].any()


def test_outputs_match_jax(slice_run):
    _, _, want, got, _ = slice_run
    for k in ("psm", "rm", "obj"):
        assert tuple(got[k].shape) == want[k].shape
        assert want[k].shape[:3] == (2, 48, 48)
        assert_close(got[k].numpy(), want[k], TOL, TOL, k)
        assert np.abs(want[k]).max() > 0
    # the border ring is off for every present agent (the rate is taken
    # before the ego row is forced on)
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                    abs=1e-6)
    assert 0.9 < float(want["comm_rate"]) < 1.0


def test_decode_keep_masks_identical(slice_run):
    hypes, _, want, got, _ = slice_run
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], np.float32)
    kw = dict(num_class=hypes["num_class"],
              obj_threshold=hypes["postprocess"]["target_args"]["obj_threshold"],
              nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=TOP_K)
    n = anchors.size // 7
    for b in range(2):
        jdet = jax_decode(jnp.asarray(want["psm"][b]), jnp.asarray(want["rm"][b]),
                          jnp.asarray(want["obj"][b]), jnp.asarray(anchors),
                          jnp.eye(4), jnp.asarray(lr), **kw)
        tdet = decode_detections(got["psm"][b], got["rm"][b], got["obj"][b],
                                 torch.from_numpy(anchors), torch.eye(4),
                                 torch.from_numpy(lr), **kw)
        # compare the keep sets per anchor: the pool order may swap scores
        # that tie to within the two frameworks' rounding
        keep = {name: np.zeros(n, bool) for name in ("jax", "torch")}
        objness = jax.nn.sigmoid(jnp.asarray(want["obj"][b])).reshape(-1)
        gated = jnp.where(objness > kw["obj_threshold"], objness, -jnp.inf)
        keep["jax"][np.asarray(jax.lax.top_k(gated, 2 * TOP_K)[1])] = jdet.mask
        objness = torch.sigmoid(got["obj"][b]).reshape(-1)
        gated = torch.where(objness > kw["obj_threshold"], objness, -torch.inf)
        idx = torch.sort(gated, descending=True, stable=True)[1][:2 * TOP_K]
        keep["torch"][idx.numpy()] = tdet.mask.numpy()
        iou = quad_iou_plain(tdet.corners[:, :4, :2].contiguous(),
                             tdet.corners[:, :4, :2].contiguous()).numpy()
        gap = np.abs(iou[np.triu_indices(len(iou), k=1)] - kw["nms_thresh"]).min()
        assert gap > 1e-4, f"an IoU lies {gap:.2e} from the NMS threshold"
        np.testing.assert_array_equal(keep["torch"], keep["jax"])
        assert 0 < keep["jax"].sum() < TOP_K
