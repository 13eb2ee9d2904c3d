"""The port's evaluation against the JAX package's, on the CPU: AP and mAP
on shared corner arrays, the seg metrics, and the evaluation CLIs end to end.

The JAX package's AP takes its IoU from the 24-candidate XLA polygon
clipper, the port's from the edge-integral ``quad_iou`` (its plain version
here); the two agree to ~1e-5, so an IoU within IOU_MARGIN of 0.3, 0.5 or
0.7 could be a TP in one package and an FP in the other. Every AP
comparison here asserts that no IoU it computed lies that close.

The CLI tests put one tiny model's flax variables into a JAX run dir (JAX's
``save_checkpoint``) and into a port run dir (the weight bridge, the port's
``save_checkpoint``), run both packages' CLI on the on-disk fixture and on
synthetic scenes, and compare the tables they write. The single-agent
confidence is made near-constant (as tests/test_torch_where2comm.py does),
so the Where2comm comm mask is decided far from its threshold.
"""

import ast
import math
import os

import jax
import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.config import save_yaml as jax_save_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.eval import ap as jax_ap
from airv2x_tpu.eval import seg_metrics as jax_seg
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.parallel.train import create_train_state, make_optimizer
from airv2x_tpu.tools import inference_airv2x as jax_multiclass
from airv2x_tpu.tools import inference_airv2x_seg as jax_seg_cli
from airv2x_tpu.tools import inference_multi_scenario as jax_multi
from airv2x_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.eval import ap
from airv2x_tpu_torch.eval import seg_metrics
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.parallel.train import TrainState
from airv2x_tpu_torch.tools import chip_ap_gate
from airv2x_tpu_torch.tools import inference, inference_airv2x
from airv2x_tpu_torch.tools import inference_airv2x_seg, inference_multi_scenario
from airv2x_tpu_torch.utils.checkpoint import save_checkpoint
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.fixture_utils import FIXTURE_SEG_HW, make_fixture
from tests.torch_port_helpers import (
    TINY, jnp_tree, one_torch_thread, random_variables, tiny_seg)

IOU_MARGIN = 1e-4
CONF = 0.012863  # tests/test_torch_where2comm.py's near-constant confidence



def bev_corners(boxes):
    """(K, 7) hwl boxes -> (K, 4, 2) f32 BEV corners (numpy)."""
    x, y, _, _, w, l, yaw = np.asarray(boxes, np.float64).T
    local = np.array([[0.5, -0.5], [0.5, 0.5], [-0.5, 0.5], [-0.5, -0.5]])
    dx = local[None, :, 0] * l[:, None]
    dy = local[None, :, 1] * w[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    return np.stack([x[:, None] + c * dx - s * dy, y[:, None] + s * dx + c * dy],
                    -1).astype(np.float32)


def iou_margin(det, gt):
    """Smallest distance of a det x gt IoU (the port's) to a threshold."""
    if not len(det) or not len(gt):
        return math.inf
    iou = quad_iou_plain(torch.from_numpy(det), torch.from_numpy(gt)).numpy()
    return float(min(np.abs(iou - t).min() for t in ap.IOU_THRESHOLDS))


def det_inputs(seed, jitter):
    """Ground truth (8 boxes) and detections (12): copies of the gt
    jittered by ``jitter`` m, some far off, with random scores and class
    labels 1 / 2 (fixed sizes: the JAX side's IoU is jitted per shape)."""
    m, n = 8, 12
    rng = np.random.default_rng(seed)
    gt = np.column_stack([rng.uniform(-30, 30, (m, 2)), np.zeros(m),
                          rng.uniform(1.4, 1.8, m), rng.uniform(1.5, 2.0, m),
                          rng.uniform(3.5, 4.5, m), rng.uniform(-np.pi, np.pi, m)])
    det = gt[rng.integers(0, m, n)].copy()
    det[:, :2] += rng.normal(0, jitter, (n, 2))
    det[:, 4:6] *= rng.uniform(0.8, 1.2, (n, 2))
    det[:, 6] += rng.normal(0, 0.2, n)
    det[: n // 4, :2] += 40.0  # matches nothing
    scores = rng.uniform(0, 1, n).astype(np.float32)
    # two classes in fixed counts, so that the JAX side's IoU (jitted per
    # shape) sees few shapes
    return (bev_corners(det), scores, rng.permutation(np.arange(n) % 2 + 1),
            bev_corners(gt), rng.permutation(np.arange(m) % 2 + 1))


@st.composite
def det_case(draw):
    seed = draw(st.integers(0, 2**31 - 1))
    return det_inputs(seed, draw(st.sampled_from([0.2, 0.6, 1.2])))


@settings(max_examples=10, deadline=None)
@given(cases=st.lists(det_case(), min_size=1, max_size=3))
def test_ap_matches_jax(cases):
    for det, _, _, gt, _ in cases:
        assume(iou_margin(det, gt) > IOU_MARGIN)
    stats = (ap.new_result_stat(), jax_ap.new_result_stat())
    scene = ap.new_result_stat()
    multi = (ap.new_multiclass_stat(2), jax_ap.new_multiclass_stat(2))
    for det, scores, labels, gt, gt_labels in cases:
        for t in ap.IOU_THRESHOLDS:
            ap.accumulate_tp_fp(torch.from_numpy(det), scores, gt, stats[0], t)
            jax_ap.accumulate_tp_fp(det, scores, gt, stats[1], t)
        ap.accumulate_scene(torch.from_numpy(det), scores, gt, scene)
        ap.accumulate_multiclass(det, scores, labels, gt, gt_labels, multi[0])
        jax_ap.accumulate_multiclass(det, scores, labels, gt, gt_labels, multi[1])
    assert stats[0] == stats[1] == scene
    assert ap.eval_final_results(stats[0]) == jax_ap.eval_final_results(stats[1])
    assert (ap.eval_multiclass_results(multi[0])
            == jax_ap.eval_multiclass_results(multi[1]))


def test_ap_edge_cases_match_jax():
    gt = bev_corners([[0, 0, 0, 1.5, 1.8, 4.0, 0.3]])
    none = np.zeros((0, 4, 2), np.float32)
    for det, scores, g in ((None, None, gt), (none, np.zeros(0), gt),
                           (gt, np.ones(1, np.float32), none),
                           (gt, np.ones(1, np.float32), gt)):
        got, want = ap.new_result_stat(), jax_ap.new_result_stat()
        for t in ap.IOU_THRESHOLDS:
            ap.accumulate_tp_fp(det, scores, g, got, t)
            jax_ap.accumulate_tp_fp(det, scores, g, want, t)
        scene = ap.new_result_stat()
        ap.accumulate_scene(det, scores, g, scene)
        assert got == want == scene
        assert ap.eval_final_results(got) == jax_ap.eval_final_results(want)
    assert ap.eval_final_results(got) == {"ap_30": 1.0, "ap_50": 1.0, "ap_70": 1.0}


def test_ap_computes_one_iou_per_scene_and_class(monkeypatch):
    """One det x gt IoU per scene serves the three thresholds (one K2
    launch on the card), and one per class present in both the detections
    and the gt in the multiclass table."""
    calls = []

    def counted(det, gt, **kw):
        calls.append((det.shape[0], gt.shape[0]))
        return quad_iou_plain(det, gt, **kw)

    monkeypatch.setattr(ap, "quad_iou", counted)
    det, scores, labels, gt, gt_labels = det_inputs(5, 0.6)
    ap.accumulate_scene(det, scores, gt, ap.new_result_stat())
    assert calls == [(len(det), len(gt))]
    calls.clear()
    ap.accumulate_multiclass(det, scores, labels, gt, gt_labels,
                             ap.new_multiclass_stat(3))
    assert sorted(calls) == sorted(((labels == c).sum(), (gt_labels == c).sum())
                                   for c in (1, 2))


@pytest.mark.parametrize("seed", [0, 1])
def test_seg_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    gd, gs = rng.integers(0, 7, (3, 40, 40)), rng.integers(0, 3, (3, 40, 40))
    pd, ps = rng.uniform(0, 1, (3, 40, 40, 7)), rng.uniform(0, 1, (3, 40, 40, 3))
    pd[0, :5] = 0.1  # nothing over the threshold: label 0
    got = seg_metrics.evaluate_segmentation(gd, pd, gs, ps)
    want = jax_seg.evaluate_segmentation(gd, pd, gs, ps)
    for part in ("dynamic", "static", "combined"):
        assert set(got[part]) == set(want[part])
        for k in want[part]:
            np.testing.assert_array_equal(got[part][k], want[part][k])
    labels = rng.integers(0, 5, (2, 30, 30))
    got = seg_metrics.evaluate_branch(gd[:2, :30, :30], labels, num_classes=7)
    want = jax_seg.evaluate_branch(gd[:2, :30, :30], labels, num_classes=7)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# The CLIs end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("eval_fixture")),
                        n_timestamps=2, with_seg=True)


def _hypes(load, seg):
    hypes = load(TINY)
    if seg:
        tiny_seg(hypes)
        hypes["seg_hw"] = hypes["model"]["args"]["seg_hw"] = FIXTURE_SEG_HW
    return hypes


def _run_dirs(tmp, seg):
    """A JAX and a port run dir holding one seeded tiny model as epoch 1."""
    hypes = _hypes(jax_load_yaml, seg)
    jmodel = jax_build_model(hypes)
    scene, _ = jax_make_scene(np.random.default_rng(0),
                              JaxSlotLayout.from_args(hypes["model"]["args"]),
                              points_per_agent=256,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"])
    example = jnp_tree({k: v[None] for k, v in scene.items()})
    var = random_variables(jmodel, example, seed=7, train=False)
    if not seg:  # a near-constant confidence: the comm mask far from 0.01
        cls = var["params"]["heads"]["cls_head"]
        cls["kernel"] = cls["kernel"] * np.float32(1e-3)
        cls["bias"] = np.full_like(cls["bias"], math.log(CONF / (1 - CONF)))
    jax_dir, port_dir = os.path.join(tmp, "jax"), os.path.join(tmp, "port")
    os.makedirs(jax_dir)
    os.makedirs(port_dir)
    jax_save_yaml(hypes, os.path.join(jax_dir, "config.yaml"))
    tx, _ = make_optimizer(hypes)
    jax_save_checkpoint(jax_dir, 1, jax.device_get(
        create_train_state(jmodel, jax.tree.map(jax.numpy.asarray, var), tx)))
    phypes = _hypes(load_yaml, seg)
    save_yaml(phypes, os.path.join(port_dir, "config.yaml"))
    model = build_model(phypes, device="cpu")
    load_flax_variables(model, var)
    save_checkpoint(port_dir, 1, TrainState(
        model, torch.optim.SGD(model.parameters(), lr=0.0)))
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def det_dirs(tmp_path_factory):
    return _run_dirs(str(tmp_path_factory.mktemp("det_runs")), seg=False)


@pytest.fixture(scope="module")
def seg_dirs(tmp_path_factory):
    return _run_dirs(str(tmp_path_factory.mktemp("seg_runs")), seg=True)


@pytest.fixture
def ap_ious(monkeypatch):
    """Every det x gt IoU matrix the port's AP computes."""
    seen = []

    def recording(c1, c2, **kw):
        out = quad_iou_plain(c1, c2)
        seen.append(out.numpy().copy())
        return out

    monkeypatch.setattr(ap, "quad_iou", recording)
    return seen


def _run_both(jax_main, port_main, jax_dir, port_dir, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog", "--model_dir", jax_dir] + argv)
    jax_main()
    return port_main(["--model_dir", port_dir, "--device", "cpu"] + argv)


def _assert_margin(ious):
    assert ious, "the AP computed no IoU"
    for iou in ious:
        for t in ap.IOU_THRESHOLDS:
            assert np.abs(iou - t).min() > IOU_MARGIN, f"an IoU near {t}"


def _table(path):
    with open(path) as f:
        return {name.strip(): ast.literal_eval(payload.strip())
                for name, payload in (line.split(":", 1) for line in f)}


SOURCES = ("dataset", "synthetic")


def _source_argv(source, root):
    if source == "dataset":
        return ["--test_dir", root]
    return ["--num_scenes", "2", "--seed", "3"]


@pytest.mark.parametrize("source", SOURCES)
def test_multi_scenario_cli_matches_jax(det_dirs, fixture_root, ap_ious,
                                        monkeypatch, source):
    jax_dir, port_dir = det_dirs
    for d in det_dirs:
        if os.path.isfile(os.path.join(d, "results.txt")):
            os.remove(os.path.join(d, "results.txt"))
    got = _run_both(jax_multi.main, inference_multi_scenario.main, jax_dir,
                    port_dir, _source_argv(source, fixture_root), monkeypatch)
    _assert_margin(ap_ious)
    want = _table(os.path.join(jax_dir, "results.txt"))
    table = _table(os.path.join(port_dir, "results.txt"))
    assert chip_ap_gate.parse_results(port_dir) == table
    assert set(table) == set(want) and "COMBINED" in table
    for name in want:
        rate = table[name].pop("comm_rate", None)
        assert rate == pytest.approx(want[name].pop("comm_rate", None), abs=1e-6)
        assert table[name] == want[name], name
    assert got["COMBINED"]["ap_30"] == table["COMBINED"]["ap_30"]
    assert got["ms_per_scene"] > 0
    assert any(v > 0 for v in want["COMBINED"].values()), "no TP: a weak test"


def test_inference_cli(det_dirs, ap_ious):
    """The synthetic-scene CLI (the JAX twin's scenes: 8 objects) writes the
    JAX CLI's ``results.txt`` line and yaml; late fusion runs on the same
    scenes (its parity: tests/test_torch_late.py)."""
    port_dir = det_dirs[1]
    got = inference.main(["--model_dir", port_dir, "--device", "cpu",
                          "--num_scenes", "2", "--seed", "5"])
    _assert_margin(ap_ious)
    line = open(os.path.join(port_dir, "results.txt")).read().splitlines()[-1]
    assert line == (f"AP@0.3: {got['ap_30']:.4f} AP@0.5: {got['ap_50']:.4f} "
                    f"AP@0.7: {got['ap_70']:.4f} comm_rate: {got['comm_rate']:.4f}")
    saved = load_yaml(os.path.join(port_dir, "eval_epoch1.yaml"))
    assert saved == {k: v for k, v in got.items() if k != "ms_per_scene"}
    assert 0.0 <= got["ap_70"] <= got["ap_50"] <= got["ap_30"] <= 1.0
    late = inference.main(["--model_dir", port_dir, "--device", "cpu",
                           "--num_scenes", "2", "--seed", "5",
                           "--fusion_method", "late"])
    assert set(late) == set(got)
    assert 0.0 <= late["ap_70"] <= late["ap_50"] <= late["ap_30"] <= 1.0


@pytest.mark.parametrize("source", SOURCES)
def test_multiclass_cli_matches_jax(det_dirs, fixture_root, ap_ious,
                                    monkeypatch, source):
    jax_dir, port_dir = det_dirs
    _run_both(jax_multiclass.main, inference_airv2x.main, jax_dir, port_dir,
              _source_argv(source, fixture_root), monkeypatch)
    _assert_margin(ap_ious)
    texts = [open(os.path.join(d, "results_multiclass.txt")).read()
             for d in det_dirs]
    assert texts[0] == texts[1]
    yamls = [jax_load_yaml(os.path.join(d, "eval_multiclass_epoch1.yaml"))
             for d in det_dirs]
    assert yamls[0]["per_class"] == yamls[1]["per_class"]


@pytest.mark.parametrize("source", SOURCES)
def test_seg_cli_matches_jax(seg_dirs, fixture_root, monkeypatch, source):
    jax_dir, port_dir = seg_dirs
    got = _run_both(jax_seg_cli.main, inference_airv2x_seg.main, jax_dir,
                    port_dir, _source_argv(source, fixture_root), monkeypatch)
    texts = [open(os.path.join(d, "results_seg.txt")).read() for d in seg_dirs]
    assert texts[0] == texts[1]
    yamls = [jax_load_yaml(os.path.join(d, "eval_seg_epoch1.yaml"))
             for d in seg_dirs]
    assert yamls[0]["dynamic"] == yamls[1]["dynamic"]
    assert yamls[0]["static"] == yamls[1]["static"]
    assert 0.0 <= got["combined_miou"] <= 1.0


def test_cli_refusals(det_dirs, seg_dirs):
    _, port_dir = det_dirs
    with pytest.raises(SystemExit):
        inference_airv2x_seg.main(["--model_dir", port_dir, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            inference_multi_scenario.main(["--model_dir", seg_dirs[1]])


def test_track_and_vis_match_jax(det_dirs, fixture_root, monkeypatch):
    """``--track --save_vis --vis_3d`` on the fixture split: the port's
    ``tracks.txt`` is JAX's line for line, and the geometry embeddings
    JAX's tool gives its tracker are the port's ``geometry_embedding`` to
    1e-6. The BEV frames: each is drawn from points within 1e-5 m of JAX's
    (the loaders' transforms round apart) and gt and detections within
    1e-4 m, and is pixel for pixel
    JAX's ``visualize`` of what the port passed it; against JAX's own frame
    it is equal off the box outlines, which may differ where a corner's
    last-bit difference changes how many samples a drawn edge takes. The
    perspective frames are written (JAX draws them with OpenCV where it is
    installed, the port in numpy: tests/test_torch_visualization.py holds
    them to JAX's numpy path)."""
    from PIL import Image

    from airv2x_tpu.models import tracking as jax_tracking
    from airv2x_tpu.visualization import bev_canvas as jax_bev
    from airv2x_tpu_torch.models.tracking import geometry_embedding

    fed, drawn = [], {"jax": [], "port": []}
    update = jax_tracking.Tracker.update

    def recording(self, boxes, emb):
        fed.append((np.array(boxes), np.array(emb)))
        return update(self, boxes, emb)

    def drawing(who, fn):
        def call(pred, gt, pts, lr, save_path=None, **kw):
            drawn[who].append((np.array(pred), np.array(gt), np.array(pts)))
            return fn(pred, gt, pts, lr, save_path=save_path, **kw)
        return call

    monkeypatch.setattr(jax_tracking.Tracker, "update", recording)
    monkeypatch.setattr(jax_bev, "visualize", drawing("jax", jax_bev.visualize))
    monkeypatch.setattr(inference_multi_scenario, "visualize",
                        drawing("port", inference_multi_scenario.visualize))
    argv = ["--test_dir", fixture_root, "--track", "--save_vis", "--vis_3d"]
    _run_both(jax_multi.main, inference_multi_scenario.main, *det_dirs, argv,
              monkeypatch)
    tracks = [open(os.path.join(d, "tracks.txt")).read().splitlines()
              for d in det_dirs]
    assert tracks[0] == tracks[1] and len(tracks[1]) >= 2
    assert any("id=" in line for line in tracks[1])
    lr = load_yaml(TINY)["preprocess"]["cav_lidar_range"]
    assert fed
    for boxes, emb in fed:
        np.testing.assert_allclose(geometry_embedding(boxes, lr), emb, atol=1e-6,
                                   rtol=0)
    frames = sorted(f for f in os.listdir(os.path.join(det_dirs[0], "vis"))
                    if f.startswith("frame_"))
    assert frames and frames == sorted(
        f for f in os.listdir(os.path.join(det_dirs[1], "vis"))
        if f.startswith("frame_"))
    assert len(drawn["jax"]) == len(drawn["port"]) == len(frames)
    outline = np.array([jax_bev.PRED_COLOR, jax_bev.GT_COLOR])
    for f, (jp, jg, jpts), (pp, pg, ppts) in zip(frames, drawn["jax"], drawn["port"]):
        np.testing.assert_allclose(ppts, jpts, atol=1e-5, rtol=0)
        np.testing.assert_allclose(pg, jg[:, :4, :2], atol=1e-4, rtol=0)
        np.testing.assert_allclose(pp, jp, atol=1e-4, rtol=0)
        assert len(pp), f"{f}: no detection drawn: a weak test"
        got, want = (np.asarray(Image.open(os.path.join(d, "vis", f)))
                     for d in reversed(det_dirs))
        np.testing.assert_array_equal(
            got, jax_bev.visualize(pp, pg, ppts, lr), err_msg=f)
        on_box = ((got[..., None, :] == outline).all(-1).any(-1)
                  | (want[..., None, :] == outline).all(-1).any(-1))
        np.testing.assert_array_equal(got[~on_box], want[~on_box], err_msg=f)
        print(f, "pixels apart on the outlines:", int((got != want).any(-1).sum()))
        assert os.path.getsize(os.path.join(det_dirs[1], "vis",
                                            f.replace("frame_", "frame3d_"))) > 0
