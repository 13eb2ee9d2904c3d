"""The DAIR-V2X data path of the port against the JAX package on the CPU:
the raw calib chain, ``DAIRDataset`` on the raw and the normalized schema,
``tools/dair_convert.py``, the loader's collate of DAIR samples, and the
refusals.

Both packages read tests/test_dair_dataset.py's fixtures (``_fixture``:
normalized; ``_raw_fixture``: the raw calib chain and ``world_8_points``
labels; ``_make_raw_dair_fixture``: a raw tree with camera calibration).
The clouds are compared within CLOUD_TOL and every transformed point is
asserted to lie more than CROP_MARGIN from the range crop; the raw labels'
boxes come out of JAX's ``corner_to_center`` in XLA f32, the port's numpy
f32 within BOX_TOL (tests/test_torch_data.py).

``DAIRDataset.__getitem__`` takes the index only in both packages, while
both ``RealDataLoader``s draw ``__getitem__(idx, epoch=...)``: neither
loader can iterate DAIR (a TypeError, ROADMAP §3), so DAIR batches are
collated from lists of samples.
"""

import copy
import json
import os

import jax
import numpy as np
import pytest

from airv2x_tpu.data import dair_dataset as jax_dair
from airv2x_tpu.data.airv2x_dataset import WildSettings as JaxWild
from airv2x_tpu.data.loader import RealDataLoader as JaxLoader
from airv2x_tpu.tools import dair_convert as jax_convert
from airv2x_tpu_torch.data import dair_dataset as port_dair
from airv2x_tpu_torch.data.airv2x_dataset import WildSettings
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.tools import dair_convert as port_convert
from airv2x_tpu_torch.utils import transforms as tf
from tests.test_dair_dataset import _fixture, _make_raw_dair_fixture, _raw_fixture
from tests.test_torch_data import (
    BOX_TOL, CROP_MARGIN, assert_same_sample, record_crop_margins)
from tests.torch_port_helpers import CHIP_SMOKE, one_torch_thread

TARGET_TOL = 1e-6  # anchor targets (tests/test_torch_data.py)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("dair")
    return {
        "normalized": _fixture(str(base / "norm"), np.random.default_rng(0)),
        "raw": _raw_fixture(str(base / "raw"), np.random.default_rng(1)),
        "raw-camera-calib": _make_raw_dair_fixture(str(base / "rawcam")),
    }


def hypes(proj_first=True, clip_pc=False):
    """The tiny SCOPE config's grid widened to the fixtures' +-40 m, as a
    DAIR config (the anchors and thresholds the loader's labels read)."""
    h = CHIP_SMOKE.tiny_scope_hypes()
    rng = [-40.0, -40.0, -3.0, 40.0, 40.0, 1.0]
    h["preprocess"]["cav_lidar_range"] = list(rng)
    h["preprocess"]["max_points"] = 1024
    h["postprocess"]["anchor_args"].update(cav_lidar_range=list(rng), W=200, H=200)
    h["postprocess"]["target_args"].update(pos_threshold=0.6, neg_threshold=0.45)
    h["fusion"] = {"args": {"proj_first": proj_first, "clip_pc": clip_pc}}
    h["model"]["core_method"] = "point_pillar"
    return h


@pytest.fixture
def crop_margins(monkeypatch):
    return record_crop_margins(monkeypatch, port_dair)


def _assert_same_value(got, want, what):
    if isinstance(want, tuple):  # (rotation, translation)
        assert isinstance(got, tuple) and len(got) == len(want), what
        for g, w in zip(got, want):
            _assert_same_value(g, w, what)
    elif isinstance(want, (list, tuple, np.ndarray)) and not isinstance(want, str):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=0,
                                   atol=1e-12, err_msg=what)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-12), what
    else:
        assert got == want, what


def test_calib_chain_matches_jax():
    """Every step of the raw calib chain on random rotations, translations
    and offsets, and the corner-set boxes (in and out of the range)."""
    rng = np.random.default_rng(7)

    def rot():
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        return (q * np.sign(np.linalg.det(q))).tolist()

    def trans():
        return rng.uniform(-50, 50, (3, 1)).tolist()

    for _ in range(5):
        l2n = {"transform": {"rotation": rot(), "translation": trans()}}
        n2w = {"rotation": rot(), "translation": trans()}
        v2w = {"rotation": rot(), "translation": trans()}
        off = {"delta_x": float(rng.normal()), "delta_y": float(rng.normal())}
        for f, args in (("_mult_coord", (l2n["transform"]["rotation"],
                                         l2n["transform"]["translation"],
                                         n2w["rotation"], n2w["translation"])),
                        ("_rt_matrix", (v2w["rotation"], v2w["translation"])),
                        ("veh_lidar_to_world", (l2n, n2w)),
                        ("inf_lidar_to_world", (v2w, off)),
                        ("inf_lidar_to_world", (v2w, None)),
                        ("camera_to_lidar_matrix", (v2w,))):
            got = getattr(port_dair, f)(*copy.deepcopy(args))
            want = getattr(jax_dair, f)(*copy.deepcopy(args))
            _assert_same_value(got, want, f)
        mat = jax_dair.veh_lidar_to_world(l2n, n2w)
        np.testing.assert_allclose(tf.world_to_pose(mat),
                                   jax_convert.tf.world_to_pose(mat), atol=1e-12)
    lr = [-40, -40, -3, 40, 40, 1]
    world_to_lidar = np.linalg.inv(tf.pose_to_world([5.0, 2.0, 1.9, 0, 20.0, 0]))
    kept = 0
    for _ in range(40):
        yaw = rng.uniform(-np.pi, np.pi)
        c, s = np.cos(yaw), np.sin(yaw)
        half = rng.uniform(0.5, 2.5, 3)
        local = np.array([[sx, sy, sz] for sz in (-1, 1)
                          for sx, sy in ((1, -1), (1, 1), (-1, 1), (-1, -1))])
        corners = (local * half) @ np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]).T
        corners += [rng.uniform(-60, 60), rng.uniform(-60, 60), rng.uniform(-3, 3)]
        got = port_dair._world_8_points_to_box(corners, world_to_lidar, lr)
        want = jax_dair._world_8_points_to_box(corners, world_to_lidar, lr)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=BOX_TOL, atol=BOX_TOL)
            kept += 1
    assert 5 < kept < 40


# (fixture, hypes kwargs, wild settings)
SAMPLES = {
    "normalized": ("normalized", {}, None),
    "normalized-wild": ("normalized", {}, dict(loc_error=True, xyz_std=1.0,
                                               ryp_std=2.0)),
    "normalized-clip-no-proj-first": ("normalized",
                                      dict(proj_first=False, clip_pc=True), None),
    "raw": ("raw", {}, None),
    "raw-camera-calib": ("raw-camera-calib", {}, None),
}


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_dataset_matches_jax(roots, crop_margins, kind):
    """The frame index (the raw entries resolved through the calib chain)
    and every sample against JAX's."""
    root, hkw, wild = SAMPLES[kind]
    jds = jax_dair.DAIRDataset(hypes(**hkw), roots[root], seed=2,
                               wild=JaxWild(**wild) if wild else None)
    tds = port_dair.DAIRDataset(hypes(**hkw), roots[root], seed=2,
                                wild=WildSettings(**wild) if wild else None)
    assert len(tds) == len(jds) == 1
    for got, want in zip(tds.frames, jds.frames):
        assert set(got) == set(want)
        for k in want:
            _assert_same_value(got[k], want[k], f"{kind} frame {k}")
    want, got = jds[0], tds[0]
    assert_same_sample(want, got, kind)
    assert got[1]["mask"].sum() == 1
    assert got[0]["points_mask"][0].any()
    if hkw.get("proj_first", True):
        assert crop_margins and min(crop_margins) > CROP_MARGIN
    else:
        assert np.abs(got[0]["pairwise_t"][1] - np.eye(4)).max() > 1.0
    if kind == "raw-camera-calib":
        assert "vehicle_camera2lidar" in tds.frames[0]


def test_dair_convert_matches_jax(roots, tmp_path):
    """The port's converter writes JAX's files (poses and labels to 1e-12),
    its CLI converts the same tree, and the converted tree reads as the raw
    one does: the same rectangles, though with length and width swapped
    and the yaw a quarter turn apart where the corner order takes edge 0-1
    as the width (the converter takes it as the length, the raw path edge
    0-3: ROADMAP §3)."""
    raw = roots["raw"]
    outs = {}
    for name, mod in (("port", port_convert), ("jax", jax_convert)):
        outs[name] = str(tmp_path / name)
        assert mod.convert(raw, outs[name]) == 1
    files = sorted(os.listdir(os.path.join(outs["jax"], "cooperative")))
    assert files == sorted(os.listdir(os.path.join(outs["port"], "cooperative")))
    assert len(files) == 2
    for f in files:
        with open(os.path.join(outs["jax"], "cooperative", f)) as fh:
            want = json.load(fh)
        with open(os.path.join(outs["port"], "cooperative", f)) as fh:
            got = json.load(fh)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                _assert_same_value(g[k], w[k], f"{f} {k}")
    cli = str(tmp_path / "cli")
    assert port_convert.main(["--raw_dir", raw, "--out_dir", cli]) == 1
    # the converted tree's frame against the raw tree's, on the raw clouds
    os.symlink(os.path.join(raw, "velodyne"), os.path.join(cli, "velodyne"))
    conv = port_dair.DAIRDataset(hypes(), cli)[0]
    direct = port_dair.DAIRDataset(hypes(), raw)[0]
    for k in ("points", "points_mask", "agent_mask"):
        np.testing.assert_allclose(conv[0][k], direct[0][k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(conv[1]["mask"], direct[1]["mask"])
    m = direct[1]["mask"]
    np.testing.assert_allclose(
        CHIP_SMOKE.bev_rectangles(conv[1]["boxes"][m]),
        CHIP_SMOKE.bev_rectangles(direct[1]["boxes"][m]), atol=1e-4)
    np.testing.assert_allclose(conv[1]["boxes"][m][:, :4],
                               direct[1]["boxes"][m][:, :4], atol=1e-4)


def test_loaders_cannot_draw_dair_and_collate_matches_jax(roots):
    """Both packages' loaders pass ``epoch`` to a ``__getitem__`` that takes
    none (a TypeError); collated from a list of samples, a DAIR batch and
    its labels equal JAX's."""
    h = hypes()
    jds = jax_dair.DAIRDataset(h, roots["normalized"])
    tds = port_dair.DAIRDataset(h, roots["normalized"])
    lj = JaxLoader(jds, h, 2, train=False, num_workers=1)
    lt = RealDataLoader(tds, h, 2, train=False, num_workers=1, device="cpu")
    for loader in (lj, lt):
        with pytest.raises(TypeError, match="epoch"):
            loader._sample(0, 0)
    bj, gj = lj._collate([jds[0], jds[0]])
    bt, gt = lt._collate([tds[0], tds[0]])
    lab_j, lab_t = bj.pop("labels"), bt.pop("labels")
    assert_same_sample((jax.tree.map(np.asarray, bj), gj),
                       ({k: v.numpy() for k, v in bt.items()}, gt), "collate")
    assert set(lab_t) == set(lab_j)
    for k in lab_j:
        got, want = lab_t[k].numpy(), np.asarray(lab_j[k])
        np.testing.assert_allclose(got, want, rtol=TARGET_TOL, atol=TARGET_TOL,
                                   err_msg=k)
    assert lab_t["pos_equal_one"].sum() > 0


def test_camera_config_refused(roots):
    """A config whose vehicle args hold a ``cam`` block is no longer
    refused: both packages give each slot's camera from the raw calib
    chain (the image resized to ``final_dim``, cam_K, camera -> lidar,
    identity post transforms), the same arrays."""
    h = hypes()
    h["model"]["args"]["vehicle"] = {"cam": {"data_aug_conf": {"final_dim": [64, 96]}}}
    got = port_dair.DAIRDataset(h, roots["raw-camera-calib"])[0][0]["cam_vehicle"]
    want = jax_dair.DAIRDataset(h, roots["raw-camera-calib"])[0][0]["cam_vehicle"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["imgs"].shape == (2, 1, 64, 96, 3) and got["imgs"][0].any()
