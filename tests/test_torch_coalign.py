"""CoAlign in the PyTorch port against the JAX package on the CPU:

  * ``elementwise_quad_iou`` (the differentiable plain-PyTorch IoU, not K2's
    plain version): values on seeded box pairs (overlapping, disjoint,
    identical, contained, a zero-width box) and gradients against
    ``jax.grad``;
  * ``point_pillar_loss_coalign``: its parts and its gradients with respect
    to psm / rm against ``jax.grad``, with and without ``anchors`` in the
    labels (without them the IoU term does not apply, in either package);
  * the tiny ``point_pillar_coalign`` (the flat family's tiny config with a
    ``res_bev_backbone``, tests/test_torch_point_pillar_family.py) forward
    with an absent slot and perturbed poses, f32, 1e-4 x (1 + scale), and
    its keep set; one train step with the IoU term against JAX's float64
    step;
  * ``refine_agent_poses`` and both pose-graph tools: the same outputs.
"""

import copy
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.loss import LOSS_REGISTRY as JAX_LOSSES
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.ops import geometry as jgeo
from airv2x_tpu.ops.anchors import generate_anchor_grid
from airv2x_tpu.ops.rotated_iou import elementwise_quad_iou as jax_quad_iou
from airv2x_tpu.tools import pose_graph_eval as jax_pg_eval
from airv2x_tpu.tools import pose_graph_pre_calc as jax_pg_pre
from airv2x_tpu.utils.pose_graph import refine_agent_poses as jax_refine
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import LOSS_REGISTRY
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.ops import geometry as geo
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.ops.rotated_iou import elementwise_quad_iou
from airv2x_tpu_torch.tools import pose_graph_eval, pose_graph_pre_calc
from airv2x_tpu_torch.utils.pose_graph import refine_agent_poses
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_point_pillar_family import batch  # noqa: F401
from tests.test_torch_point_pillar_family import tiny_hypes as flat_hypes
from tests.torch_port_helpers import REPO, one_torch_thread, random_variables  # noqa: F401
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    port_step, twin)

TOL = 1e-4  # whole-model outputs, f32, x (1 + scale)
IOU_TOL = 1e-5
GRAD_TOL = 1e-4  # of the largest gradient
NMS_MARGIN = 1e-4
TOP_K = 256
# the tiny model's variables seed: the first from 5 up whose NMS IoUs on the
# scene lie more than ten times NMS_MARGIN from the threshold (seed 5's lie
# 3.4e-5 from it)
COALIGN_SEED = 18
LOSS_ARGS = {"cls_weight": 1.0, "reg": 2.0, "iou_weight": 1.0}


def _pairs(seed=0, n=256):
    """Seeded hwl box pairs: jittered copies (overlapping), far shifts
    (disjoint), contained ones, plus an identical pair and a zero-width box."""
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                  np.zeros(n), rng.uniform(1, 2, n), rng.uniform(1, 3, n),
                  rng.uniform(2, 5, n), rng.uniform(-np.pi, np.pi, n)], -1)
    b = a.copy()
    b[:, :2] += rng.normal(0, 1.0, (n, 2))
    b[:, 4:6] *= rng.uniform(0.5, 1.5, (n, 2))
    b[:, 6] += rng.normal(0, 0.5, n)
    b[n // 8:n // 4, :2] += 40.0  # disjoint
    b[n // 4:n // 4 + 8, 4:6] = a[n // 4:n // 4 + 8, 4:6] * 0.3  # contained
    b[n // 4:n // 4 + 8, :2] = a[n // 4:n // 4 + 8, :2]
    b[-1] = a[-1]  # identical
    b[-2, 4] = 0.0  # zero width
    return a.astype(np.float32), b.astype(np.float32)


def _corners(boxes, lib):
    if lib == "jax":
        return jgeo.boxes_to_corners_bev(jnp.asarray(boxes), order="hwl")
    return geo.boxes_to_corners_bev(torch.from_numpy(boxes), order="hwl")


def test_quad_iou_matches_jax():
    a, b = _pairs()
    want = np.asarray(jax_quad_iou(_corners(a, "jax"), _corners(b, "jax")))
    got = elementwise_quad_iou(_corners(a, "port"), _corners(b, "port")).numpy()
    np.testing.assert_allclose(got, want, atol=IOU_TOL, rtol=0)
    assert want[-1] == pytest.approx(1.0, abs=1e-5)
    assert (want[32:64] == 0).all() and (want > 0.05).sum() > 100
    # a near-zero-area quad: the XLA function's own rule, not K2's zero
    assert got[-2] == pytest.approx(float(want[-2]), abs=IOU_TOL)


def test_quad_iou_gradients_match_jax():
    """d(sum of weighted IoUs)/d(corners) on the general-position pairs (the
    identical and zero-width pairs left out: their candidates coincide)."""
    a, b = _pairs(seed=1)
    a, b = a[:-2], b[:-2]
    wts = np.random.default_rng(2).uniform(0.5, 1.5, len(a)).astype(np.float32)
    ca, cb = (np.array(_corners(x, "jax")) for x in (a, b))
    ga, gb = jax.grad(lambda p, q: jnp.sum(jax_quad_iou(p, q) * wts),
                      argnums=(0, 1))(jnp.asarray(ca), jnp.asarray(cb))
    ta = torch.from_numpy(ca).requires_grad_(True)
    tb = torch.from_numpy(cb).requires_grad_(True)
    (elementwise_quad_iou(ta, tb) * torch.from_numpy(wts)).sum().backward()
    for got, want in ((ta.grad, ga), (tb.grad, gb)):
        want = np.asarray(want)
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def _loss_inputs(seed=3, with_anchors=True):
    aargs = {"W": 16, "H": 16, "l": 3.9, "w": 1.6, "h": 1.56, "r": [0, 90],
             "feature_stride": 2, "vw": 0.4, "vh": 0.4,
             "cav_lidar_range": [-3.2, -3.2, -3, 3.2, 3.2, 1]}
    anchors = generate_anchor_grid(aargs).astype(np.float32)
    h, w, a = anchors.shape[:3]
    rng = np.random.default_rng(seed)
    out = {"psm": rng.normal(size=(2, h, w, a)).astype(np.float32),
           "rm": rng.normal(0, 0.3, (2, h, w, 7 * a)).astype(np.float32)}
    pos = (rng.uniform(size=(2, h, w, a)) < 0.05).astype(np.float32)
    tgt = {"pos_equal_one": pos,
           "targets": rng.normal(0, 0.3, (2, h, w, 7 * a)).astype(np.float32)}
    if with_anchors:
        tgt["anchors"] = anchors
    return out, tgt


@pytest.mark.parametrize("with_anchors", [True, False])
def test_coalign_loss_and_gradients_match_jax(with_anchors):
    out, tgt = _loss_inputs(with_anchors=with_anchors)
    jfn = JAX_LOSSES["point_pillar_loss_coalign"](LOSS_ARGS)
    jt = {k: jnp.asarray(v) for k, v in tgt.items()}

    def jtotal(psm, rm):
        return jfn({"psm": psm, "rm": rm}, jt)[0]

    _, jparts = jfn({k: jnp.asarray(v) for k, v in out.items()}, jt)
    gpsm, grm = jax.grad(jtotal, argnums=(0, 1))(jnp.asarray(out["psm"]),
                                                 jnp.asarray(out["rm"]))
    fn = LOSS_REGISTRY["point_pillar_loss_coalign"](LOSS_ARGS)
    t_out = {k: torch.from_numpy(v).requires_grad_(True) for k, v in out.items()}
    total, parts = fn(t_out, {k: torch.from_numpy(v) for k, v in tgt.items()})
    total.backward()
    assert set(parts) == set(jparts)
    assert ("iou_loss" in parts) == with_anchors
    for k in parts:
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=1e-5), k
    for got, want in ((t_out["psm"].grad, gpsm), (t_out["rm"].grad, grm)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())
    if with_anchors:
        assert 0.1 < float(parts["iou_loss"]) < 1.0


# ---------------------------------------------------------------------------
# the tiny model
# ---------------------------------------------------------------------------


def coalign_hypes():
    """The flat family's tiny config as CoAlign: its backbone under
    ``res_bev_backbone`` (always ResNet), no shrink, the model's own
    ``voxel_size`` and the CoAlign loss."""
    h = flat_hypes("point_pillar")
    args = h["model"]["args"]
    h["model"]["core_method"] = "point_pillar_coalign"
    bb = args.pop("base_bev_backbone")
    bb.pop("resnet", None)
    args["res_bev_backbone"] = bb
    del args["shrink_header"]
    args["voxel_size"] = [0.4, 0.4, 4]
    h["loss"] = {"core_method": "point_pillar_loss_coalign",
                 "args": copy.deepcopy(LOSS_ARGS)}
    return h


def _scene(b):
    return {k: v for k, v in b.items() if k != "labels"}


@pytest.fixture(scope="module")
def tiny_run(batch):  # noqa: F811
    hypes = coalign_hypes()
    jmodel = jax_build_model(hypes)
    jb = jax.tree.map(jnp.asarray, _scene(batch))
    var = random_variables(jmodel, jb, seed=COALIGN_SEED, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(var, jb))
    return hypes, var, want


def test_tiny_coalign_matches_jax(batch, tiny_run):  # noqa: F811
    hypes, var, want = tiny_run
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    for k in ("psm", "rm"):
        w = want[k]
        assert got[k].shape == w.shape == (2, 32, 32, 2 if k == "psm" else 14)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * (1 + np.abs(w).max()), err_msg=k)
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0


def keep_sets(hypes, want, got):
    """Every sample's keep set per anchor from JAX's and the port's
    ``decode_detections`` of the binary heads (psm is the score), and the
    smallest distance of the port's candidates' IoUs from the NMS
    threshold: ([(jax keep, port keep)], margin)."""
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], np.float32)
    post = hypes["postprocess"]
    kw = dict(num_class=1, obj_threshold=post["target_args"].get(
        "obj_threshold", 0.2), nms_thresh=post.get("nms_thresh", 0.15),
        top_k=TOP_K)
    n = anchors.shape[0] * anchors.shape[1] * anchors.shape[2]
    pairs, margin = [], 1.0
    for b in range(want["psm"].shape[0]):
        psm = jnp.asarray(want["psm"][b])
        det = jax_decode(psm, jnp.asarray(want["rm"][b]), psm,
                         jnp.asarray(anchors), jnp.eye(4), jnp.asarray(lr), **kw)
        gated = jnp.where(jax.nn.sigmoid(psm).reshape(-1) > kw["obj_threshold"],
                          jax.nn.sigmoid(psm).reshape(-1), -jnp.inf)
        jkeep = np.zeros(n, bool)
        jkeep[np.asarray(jax.lax.top_k(gated, 2 * TOP_K)[1])] = det.mask
        tpsm = got["psm"][b]
        tdet = decode_detections(tpsm, got["rm"][b], tpsm,
                                 torch.from_numpy(anchors), torch.eye(4),
                                 torch.from_numpy(lr), **kw)
        obj = torch.sigmoid(tpsm).reshape(-1)
        gated = torch.where(obj > kw["obj_threshold"], obj, -torch.inf)
        tkeep = np.zeros(n, bool)
        tkeep[torch.sort(gated, descending=True, stable=True)[1][
            :2 * TOP_K].numpy()] = tdet.mask.numpy()
        live = tdet.corners[:, :4, :2].contiguous()
        iou = quad_iou_plain(live, live).numpy()
        if len(iou) > 1:
            margin = min(margin, float(np.abs(
                iou[np.triu_indices(len(iou), k=1)] - kw["nms_thresh"]).min()))
        pairs.append((jkeep, tkeep))
    return pairs, margin


def test_tiny_coalign_keep_sets_match_jax(batch, tiny_run):  # noqa: F811
    hypes, var, want = tiny_run
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    pairs, margin = keep_sets(hypes, want, got)
    assert margin > NMS_MARGIN, margin
    for jkeep, tkeep in pairs:
        np.testing.assert_array_equal(tkeep, jkeep)
        assert 0 < jkeep.sum() < TOP_K


def test_tiny_coalign_absent_slot_does_not_enter(batch, tiny_run):  # noqa: F811
    hypes, var, _ = tiny_run
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    moved = dict(_scene(batch), points=batch["points"].copy())
    moved["points"][1, 2, :, :2] *= 0.5
    with torch.no_grad():
        a = model(batch_to_torch(_scene(batch), "cpu"))
        b = model(batch_to_torch(moved, "cpu"))
    assert torch.equal(a["psm"], b["psm"])


@pytest.fixture(scope="module")
def step_run(batch):  # noqa: F811
    """One update from the same variables with the anchor grid in the
    labels, so the IoU term applies: the port's f32 step and JAX's float64
    step."""
    hypes = coalign_hypes()
    b = copy.deepcopy(batch)
    b["labels"]["anchors"] = generate_anchor_grid(
        hypes["postprocess"]["anchor_args"]).astype(np.float32)
    var = random_variables(jax_build_model(hypes),
                           jax.tree.map(jnp.asarray, _scene(b)), seed=5,
                           train=False)
    params, stats, jparts, grads = jax_step(hypes, b, var, dtype=jnp.float64)
    model, parts = port_step(hypes, b, var)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(hypes, grads, stats), after=twin(hypes, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])
    assert 0 < step_run["parts"]["iou_loss"] < 1


def test_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"])


def test_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100) > 0


# ---------------------------------------------------------------------------
# the pose graph
# ---------------------------------------------------------------------------


def _world(rng, k=8):
    return np.stack([rng.uniform(-30, 30, k), rng.uniform(-15, 15, k),
                     rng.uniform(-np.pi, np.pi, k)], axis=-1)


def _to_frame(world, pose):
    tx, ty, yaw = pose
    c, s = np.cos(yaw), np.sin(yaw)
    x, y = world[:, 0] - tx, world[:, 1] - ty
    return np.stack([c * x + s * y, -s * x + c * y, world[:, 2] - yaw], axis=-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_agent_poses_matches_jax(seed):
    rng = np.random.default_rng(seed)
    world = _world(rng)
    true = np.array([[0, 0, 0], [5.0, -2.0, 0.3], [-8.0, 3.0, -0.2]])
    boxes = [_to_frame(world, p) for p in true]
    noisy = true.copy()
    noisy[1:] += rng.normal(0, [0.6, 0.6, 0.05], (2, 3))
    got = refine_agent_poses(boxes, noisy)
    np.testing.assert_array_equal(got, jax_refine(boxes, noisy))
    assert np.abs(got - true).sum() < np.abs(noisy - true).sum()


def test_pose_graph_pre_calc_writes_the_jax_files(tmp_path, monkeypatch):
    path = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
    argv = ["--hypes_yaml", path, "--split_dir", str(tmp_path / "none"),
            "--num_scenes", "3", "--pos_std", "0.4", "0.2", "--rot_std", "0.1",
            "0.05"]
    monkeypatch.setattr(sys, "argv", ["prog", "--output", str(tmp_path / "jax")]
                        + argv)
    jax_pg_pre.main()
    got = pose_graph_pre_calc.main(["--output", str(tmp_path / "port")] + argv)
    assert len(got) == 2
    n = 0
    for sweep in ("pos0.4_rot0.1", "pos0.2_rot0.05"):
        names = sorted(os.listdir(tmp_path / "jax" / sweep))
        assert names == sorted(os.listdir(tmp_path / "port" / sweep))
        for name in names:
            a = np.load(tmp_path / "jax" / sweep / name)
            b = np.load(tmp_path / "port" / sweep / name)
            for k in ("pairwise_t", "agent_mask"):
                np.testing.assert_array_equal(a[k], b[k])
            n += int(np.abs(a["pairwise_t"] - np.eye(4)).max() > 0)
    assert n >= 3  # the refined poses moved from the identity


def test_pose_graph_eval_prints_the_jax_numbers(capsys, monkeypatch):
    argv = ["--num_scenes", "4", "--num_agents", "3", "--seed", "1"]
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    jax_pg_eval.main()
    want = capsys.readouterr().out
    got = pose_graph_eval.main(argv)
    assert capsys.readouterr().out == want
    assert got["after"] < got["before"]
