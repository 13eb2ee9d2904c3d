"""The port's data layer against the JAX package's, on the CPU: PCD files,
the pose helpers, ``AirV2XDataset``, the augmentor, the prefetcher,
``RealDataLoader``, the run-dir helpers, ``chip_smoke.py``'s on-disk
scenario, and the train CLI on a real ``root_dir``.

Both packages read the on-disk fixture of ``tests/fixture_utils.py``. The
JAX dataset reads PCD files through its native reader where
``native/libfastpcd.so`` builds (C float32), else through its numpy
fallback; the port has one numpy reader. The clouds are compared row by row
within CLOUD_TOL x (1 + |x|), and every transformed point is asserted to
lie more than CROP_MARGIN from the range crop, so no point can fall on the
two sides of it. The gt boxes come out of JAX's ``corner_to_center`` in
XLA f32, which fuses the BEV edge norm into an FMA and has its own atan2:
the port's numpy f32 lies within a few ulps (BOX_TOL x (1 + |x|)); masks,
classes and the other keys are equal.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data import native as jax_native
from airv2x_tpu.data.airv2x_dataset import AirV2XDataset as JaxDataset
from airv2x_tpu.data.airv2x_dataset import WildSettings as JaxWild
from airv2x_tpu.data.augment import DataAugmentor as JaxAugmentor
from airv2x_tpu.data.loader import RealDataLoader as JaxLoader
from airv2x_tpu.data.pcd import read_pcd as jax_read_pcd
from airv2x_tpu.data.pcd import write_pcd as jax_write_pcd
from airv2x_tpu.utils import transforms as jax_tf
from airv2x_tpu.utils.checkpoint import find_best_epoch as jax_find_best_epoch
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data import airv2x_dataset as port_dataset
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset, WildSettings
from airv2x_tpu_torch.data.augment import DataAugmentor
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.data.pcd import load_pcd_into, read_pcd, write_pcd
from airv2x_tpu_torch.data.prefetch import Prefetcher
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.tools import train as port_train
from airv2x_tpu_torch.utils import transforms as tf
from airv2x_tpu_torch.utils.checkpoint import find_best_epoch
from tests.fixture_utils import cam_hypes, make_fixture
from tests.torch_port_helpers import (
    CHIP_SMOKE, FLAGSHIP, TINY, one_torch_thread, tiny_seg)

CLOUD_TOL = 1e-5  # x (1 + |x|): C float32 against numpy float32 transforms
CROP_MARGIN = 1e-4  # m: every transformed point this far from the crop
BOX_TOL = 1e-6  # x (1 + |x|): a few f32 ulps of XLA's FMA and atan2
TARGET_TOL = 1e-6  # anchor targets of those boxes



@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("airv2x_fixture")
    return make_fixture(str(root), n_timestamps=4, with_seg=True)


def _tiny(seg=False, max_points=1024, package="port"):
    load = load_yaml if package == "port" else jax_load_yaml
    hypes = load(TINY)
    hypes["preprocess"]["max_points"] = max_points
    return tiny_seg(hypes) if seg else hypes


@pytest.fixture
def crop_margins(monkeypatch):
    """Record, for every cloud the port's dataset loads with a transform,
    the smallest distance of a transformed point to a face of the range
    crop (both readers read an untransformed cloud's floats bit for bit)."""
    return record_crop_margins(monkeypatch, port_dataset)


def record_crop_margins(monkeypatch, module):
    """The margins list that ``crop_margins`` records, for the dataset
    ``module`` whose ``load_pcd_into`` it wraps."""
    margins = []
    real = module.load_pcd_into

    def recording(path, out, *, transform=None, lidar_range=None, ego_mask=0.0):
        if transform is not None:
            pts = read_pcd(path)
            pts = pts[~((np.abs(pts[:, 0]) < ego_mask)
                        & (np.abs(pts[:, 1]) < ego_mask))]
            pts = tf.transform_points(pts, transform).astype(np.float32)
            lr = np.asarray(lidar_range, np.float32)
            margins.append(float(np.abs(pts[:, [0, 1, 2, 0, 1, 2]] - lr).min()))
        return real(path, out, transform=transform, lidar_range=lidar_range,
                    ego_mask=ego_mask)

    monkeypatch.setattr(module, "load_pcd_into", recording)
    return margins


def assert_same_sample(want, got, what=""):
    """A JAX (batch, gt) against the port's: keys, shapes and dtypes equal;
    the points within CLOUD_TOL where valid, the gt boxes within BOX_TOL,
    everything else equal, the ``cam_<type>`` blocks leaf by leaf."""
    (bj, gj), (bt, gt) = want, got
    assert set(bj) == set(bt), (what, set(bj) ^ set(bt))
    for k in bj:
        if isinstance(bj[k], dict):
            assert isinstance(bt[k], dict) and set(bt[k]) == set(bj[k]), (what, k)
            for kk, v in bj[k].items():
                a, b = np.asarray(v), np.asarray(bt[k][kk])
                assert a.shape == b.shape and a.dtype == b.dtype, (
                    what, k, kk, a.shape, b.shape)
                np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}.{kk}")
            continue
        a, b = np.asarray(bj[k]), np.asarray(bt[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k, a.shape, b.shape)
        if k == "points":
            m = np.asarray(bj["points_mask"])
            np.testing.assert_array_equal(m, bt["points_mask"], err_msg=what)
            np.testing.assert_allclose(b[m], a[m], rtol=CLOUD_TOL, atol=CLOUD_TOL,
                                       err_msg=f"{what} points")
            np.testing.assert_array_equal(b[~m], a[~m], err_msg=what)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")
    for k in ("mask", "classes"):
        np.testing.assert_array_equal(gt[k], gj[k], err_msg=f"{what} gt {k}")
    np.testing.assert_allclose(gt["boxes"], gj["boxes"], rtol=BOX_TOL, atol=BOX_TOL,
                               err_msg=f"{what} gt boxes")


# ---------------------------------------------------------------------------
# PCD files and poses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax binary", "jax ascii"])
def test_pcd_round_trip_and_cross_read(tmp_path, writer):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 20, (300, 4)).astype(np.float32)
    pts[7, 1] = np.nan  # dropped on read
    path = str(tmp_path / "c.pcd")
    if writer == "port":
        write_pcd(path, pts)
    else:
        jax_write_pcd(path, pts, binary=writer == "jax binary")
    got = read_pcd(path)
    np.testing.assert_array_equal(got, np.delete(pts, 7, axis=0))
    np.testing.assert_array_equal(got, jax_read_pcd(path))


@pytest.mark.parametrize("reader", ["python", "jax default"])
def test_load_pcd_into_matches_jax(tmp_path, monkeypatch, reader):
    """Against the JAX package's numpy path exactly, and against whichever
    reader its dataset uses (the native one where it builds) within
    CLOUD_TOL, with the crop margin asserted."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-30, 30, (2000, 4)).astype(np.float32)
    pts[:60, :2] = 0.5  # on the carrier: ego-masked
    path = str(tmp_path / "c.pcd")
    write_pcd(path, pts)
    t = tf.pose_to_world([3.0, -2.0, 0.5, 1.0, 25.0, -2.0]).astype(np.float32)
    lr = np.array([-20, -20, -25, 20, 20, 25], np.float32)
    moved = tf.transform_points(pts[60:], t).astype(np.float32)
    assert np.abs(moved[:, [0, 1, 2, 0, 1, 2]] - lr).min() > CROP_MARGIN
    if reader == "python":
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    out_j = np.zeros((1500, 4), np.float32)
    out_t = np.zeros((1500, 4), np.float32)
    kw = dict(transform=t, lidar_range=lr, ego_mask=2.0)
    n_j = jax_native.load_pcd_into(path, out_j, **kw)
    n_t = load_pcd_into(path, out_t, **kw)
    assert n_t == n_j and 0 < n_t < 1500
    if reader == "python":
        np.testing.assert_array_equal(out_t, out_j)
    else:
        np.testing.assert_allclose(out_t, out_j, rtol=CLOUD_TOL, atol=CLOUD_TOL,
                                   err_msg=f"native {jax_native.native_available()}")
    with pytest.raises(ValueError, match="float32"):
        load_pcd_into(path, np.zeros((10, 4)))


def test_transforms_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        a = rng.uniform(-100, 100, 6)
        b = rng.uniform(-100, 100, 6)
        np.testing.assert_array_equal(tf.pose_to_world(a), jax_tf.pose_to_world(a))
        np.testing.assert_array_equal(tf.pose_a_to_b(a, b), jax_tf.pose_a_to_b(a, b))
        np.testing.assert_array_equal(tf.world_to_pose(tf.pose_a_to_b(a, b)),
                                      jax_tf.world_to_pose(tf.pose_a_to_b(a, b)))
        pts = rng.normal(0, 10, (50, 4))
        t = tf.pose_a_to_b(a, b)
        np.testing.assert_array_equal(tf.transform_points(pts, t),
                                      jax_tf.transform_points(pts, t))
    np.testing.assert_array_equal(
        tf.add_pose_noise(a, np.random.default_rng(9), 0.2, 0.3),
        jax_tf.add_pose_noise(a, np.random.default_rng(9), 0.2, 0.3))


# ---------------------------------------------------------------------------
# The dataset
# ---------------------------------------------------------------------------

WILD = {"default": {}, "latency+noise": dict(async_mode=True, loc_error=True,
                                             xyz_std=0.5, ryp_std=2.0)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("wild", sorted(WILD))
def test_dataset_matches_jax(fixture_root, crop_margins, wild, train):
    ds_j = JaxDataset(_tiny(True, package="jax"), fixture_root, train=train,
                      wild=JaxWild(**WILD[wild]), seed=5)
    ds_t = AirV2XDataset(_tiny(True), fixture_root, train=train,
                         wild=WildSettings(**WILD[wild]), seed=5)
    assert len(ds_t) == len(ds_j) == 4
    assert ds_t.samples == ds_j.samples
    for idx in range(len(ds_t)):
        for epoch in (0, 1):
            got = ds_t.__getitem__(idx, epoch=epoch)
            assert_same_sample(ds_j.__getitem__(idx, epoch=epoch), got,
                               f"{wild} train={train} sample {idx} epoch {epoch}")
            assert {"dynamic_seg_label", "static_seg_label"} <= set(got[0])
            assert got[1]["mask"].sum() == 1  # the in-range fixture object
    assert min(crop_margins) > CROP_MARGIN


def test_dataset_temporal_frames_match_jax(fixture_root, crop_margins):
    hypes = [_tiny(package=p) for p in ("jax", "port")]
    for h in hypes:
        h["fusion"]["args"]["num_sweep_frames"] = 2
        h["fusion"]["args"]["proj_first"] = False
    ds_j = JaxDataset(hypes[0], fixture_root, train=True, seed=1)
    ds_t = AirV2XDataset(hypes[1], fixture_root, train=True, seed=1)
    for idx in (0, 3):
        got = ds_t[idx]
        assert got[0]["points"].shape[0] == 2 and got[0]["history_t"].shape == (2, 4, 4)
        assert_same_sample(ds_j[idx], got, f"frames sample {idx}")
    assert crop_margins == []  # proj_first false: the clouds stay as read


def test_dataset_refuses_camera_configs(tmp_path):
    """A BM2CP config builds in both packages, its BM2CP branch on
    (tests/test_torch_bm2cp_data.py holds its samples). A shipped camera
    YAML, whose ``data_aug_conf``
    gives only ``final_dim``, is refused by both packages at the first
    camera read (KeyError on ``H``), the port naming every missing key;
    with the keys supplied (``cam_hypes``) both read the same sample
    (tests/test_torch_camera_data.py holds every camera path)."""
    root = make_fixture(str(tmp_path / "cam"), n_timestamps=1, with_camera=True)
    bm2cp = _tiny()
    bm2cp["model"]["core_method"] = "airv2x_bm2cp"
    assert AirV2XDataset(bm2cp, root).bm2cp and JaxDataset(bm2cp, root).bm2cp
    shipped = os.path.join(os.path.dirname(TINY), "..", "airv2x", "camera",
                           "det", "where2comm.yaml")
    for load, dataset in ((jax_load_yaml, JaxDataset), (load_yaml, AirV2XDataset)):
        ds = dataset(load(shipped), root, train=False)
        with pytest.raises(KeyError, match="H"):
            ds[0]
    with pytest.raises(KeyError, match="resize_lim"):
        AirV2XDataset(load_yaml(shipped), root, train=False)[0]
    hypes = [cam_hypes(_tiny(package=p), ("vehicle", "rsu")) for p in ("jax", "port")]
    got = AirV2XDataset(hypes[1], root, train=True, seed=4)[0]
    assert {"cam_vehicle", "cam_rsu"} <= set(got[0])
    assert_same_sample(JaxDataset(hypes[0], root, train=True, seed=4)[0], got,
                       "camera sample")


def test_augmentor_matches_jax():
    cfg = [{"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
           {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.7, 0.7]},
           {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.9, 1.1]}]
    rng = np.random.default_rng(6)
    pts = rng.normal(0, 10, (4, 100, 4)).astype(np.float32)
    boxes = rng.normal(0, 5, (7, 7)).astype(np.float32)
    for seed in range(8):
        got = DataAugmentor(cfg)(pts, boxes, np.random.default_rng(seed))
        want = JaxAugmentor(cfg)(pts, boxes, np.random.default_rng(seed))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    same = DataAugmentor(cfg, train=False)(pts, boxes, np.random.default_rng(0))
    assert same[0] is pts and same[1] is boxes
    with pytest.raises(KeyError):
        DataAugmentor([{"NAME": "random_world_shear"}])


# ---------------------------------------------------------------------------
# Prefetch and the loader
# ---------------------------------------------------------------------------


def test_prefetcher_order_and_worker_error():
    pf = Prefetcher(lambda i: i * 10, range(25), num_workers=3, buffer_size=4)
    assert list(pf) == [i * 10 for i in range(25)]

    def make(i):
        if i == 5:
            raise KeyError("bad sample")
        return i

    got = []
    with pytest.raises(RuntimeError, match="prefetch worker failed") as err:
        for b in Prefetcher(make, range(10), num_workers=2, buffer_size=2):
            got.append(b)
    assert got == [0, 1, 2, 3, 4]
    assert isinstance(err.value.__cause__, KeyError)


LOADERS = {"det": dict(seg=False), "seg": dict(seg=True),
           "det+augment": dict(seg=False, augment=True)}


@pytest.mark.parametrize("kind", sorted(LOADERS))
def test_loader_matches_jax(fixture_root, kind):
    cfg = dict(LOADERS[kind])
    augment = cfg.pop("augment", False)
    hypes = [_tiny(package=p, **cfg) for p in ("jax", "port")]
    for h in hypes:
        if augment:
            h["train_params"]["augment"] = True
            h["data_augment"] = [
                {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": [-0.5, 0.5]},
                {"NAME": "random_world_scaling"}]
    kw = dict(batch_size=2, train=True, seed=3, num_workers=2)
    lj = JaxLoader(JaxDataset(hypes[0], fixture_root, seed=3), hypes[0], **kw)
    lt = RealDataLoader(AirV2XDataset(hypes[1], fixture_root, seed=3), hypes[1],
                        device="cpu", **kw)
    assert len(lt) == len(lj) == 2
    for epoch in (0, 1):
        assert lt.epoch_indices(epoch) == lj.epoch_indices(epoch)
        for (bj, gj), (bt, gt) in zip(lj.batches(epoch, with_gt=True),
                                      lt.batches(epoch, with_gt=True)):
            assert all(isinstance(v, torch.Tensor) for k, v in bt.items()
                       if k != "labels")
            lab_j, lab_t = bj.pop("labels"), bt.pop("labels")
            assert_same_sample((bj, gj), ({k: v.numpy() for k, v in bt.items()}, gt),
                               f"{kind} epoch {epoch}")
            assert set(lab_t) == set(lab_j)
            for k in lab_j:
                got, want = lab_t[k].numpy(), np.asarray(lab_j[k])
                assert got.dtype == want.dtype, k
                if k == "targets":
                    np.testing.assert_allclose(got, want, rtol=TARGET_TOL,
                                               atol=TARGET_TOL)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=k)
            assert lab_t["pos_equal_one"].sum() > 0
            if kind == "seg":
                assert lab_t["dynamic_seg_label"].shape[0] == 2
    for host in (0, 1):
        a = RealDataLoader(lt.dataset, hypes[1], 1, host_id=host, num_hosts=3,
                           device="cpu")
        b = JaxLoader(lj.dataset, hypes[0], 1, host_id=host, num_hosts=3)
        assert a.epoch_indices(2) == b.epoch_indices(2) and len(a) == len(b)


# ---------------------------------------------------------------------------
# Run dirs, the chip_smoke scenario, the train CLI on a root_dir
# ---------------------------------------------------------------------------


def test_load_yaml_model_dir_and_find_best_epoch(tmp_path):
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    hypes = load_yaml(TINY)
    hypes["name"] = "snapshot"
    for d in (port_dir, jax_dir):
        d.mkdir()
        save_yaml(hypes, str(d / "config.yaml"))
        (d / "validation_loss.txt").write_text(
            "epoch: 1, loss: 0.9000\nepoch: 2, loss: 0.5000\n"
            "epoch: 3, loss: 0.7000\nepoch: 4, loss: 0.4000\n")
    for e in (1, 2, 3):  # epoch 4 has no checkpoint: 2 is the best saved
        (port_dir / f"net_epoch{e}").write_bytes(b"")
        (jax_dir / f"net_epoch{e}").mkdir()
    assert find_best_epoch(str(port_dir)) == jax_find_best_epoch(str(jax_dir)) == 2
    (port_dir / "validation_loss.txt").unlink()
    assert find_best_epoch(str(port_dir)) == 3  # no losses: the last epoch
    assert find_best_epoch(str(tmp_path / "absent")) == 0
    got = load_yaml(None, str(port_dir))
    want = jax_load_yaml(None, str(jax_dir))
    assert got["name"] == want["name"] == "snapshot"
    assert load_yaml(TINY, str(port_dir))["name"] == "snapshot"  # the snapshot wins
    assert got["postprocess"]["anchor_args"] == want["postprocess"]["anchor_args"]
    assert load_yaml(TINY, str(tmp_path / "absent"))["name"] == "tiny_where2comm"


def test_chip_smoke_scenario_matches_fixture_layout(tmp_path, crop_margins):
    """``chip_smoke.py:write_scenario`` writes the fixture's layout, and both
    packages' datasets read the same samples from it."""
    fix = make_fixture(str(tmp_path / "fixture"), n_timestamps=1, with_seg=True)
    hypes = CHIP_SMOKE.cut_hypes(FLAGSHIP)
    hypes["preprocess"]["max_points"] = 2000
    root = CHIP_SMOKE.write_scenario(
        str(tmp_path / "scenario"), SlotLayout.from_args(hypes["model"]["args"]),
        hypes["preprocess"]["cav_lidar_range"], stamps=2, points_per_agent=1500,
        seg_hw=64)

    def layout(r):
        (scen,) = os.listdir(r)
        tdir = os.path.join(r, scen, sorted(os.listdir(os.path.join(r, scen)))[0])
        agents = sorted(d for d in os.listdir(tdir) if d.startswith("agent_"))
        with open(os.path.join(tdir, agents[0], "metadata.pkl"), "rb") as f:
            meta = pickle.load(f)
        with open(os.path.join(tdir, "objects.pkl"), "rb") as f:
            obj = next(iter(pickle.load(f).values()))
        return (sorted(os.listdir(tdir)) == ["objects.pkl"] + agents,
                sorted(os.listdir(os.path.join(tdir, agents[0]))),
                {k: sorted(v) if isinstance(v, dict) else type(v).__name__
                 for k, v in meta.items()}, sorted(obj),
                os.path.basename(tdir)[:10], agents[0][:6])

    assert layout(root) == layout(fix)
    jax_hypes = jax_load_yaml(FLAGSHIP)
    for k in ("model", "train_params"):
        jax_hypes[k]["max_cav"] = dict(CHIP_SMOKE.NUM_AGENTS)
    jax_hypes["model"]["args"]["max_cav"] = dict(CHIP_SMOKE.NUM_AGENTS)
    jax_hypes["preprocess"]["max_points"] = 2000
    for train in (False, True):
        ds_t = AirV2XDataset(hypes, root, train=train)
        ds_j = JaxDataset(jax_hypes, root, train=train)
        for idx in range(len(ds_t)):
            got = ds_t[idx]
            assert_same_sample(ds_j[idx], got, f"scenario {idx} train={train}")
            assert got[0]["agent_mask"].all()
            if not train:  # ego agent 1, whose frame the objects were drawn in
                assert got[1]["mask"].sum() == 12
    assert min(crop_margins) > CROP_MARGIN


def test_train_cli_on_a_root_dir(fixture_root, tmp_path):
    """The port's train CLI trains on the fixture split on the CPU (the
    loader, 2 workers, batch 2) and its loss falls, as
    tests/test_real_training.py shows for the JAX loop."""
    hypes = _tiny()
    hypes["root_dir"] = fixture_root
    hypes["validate_dir"] = fixture_root
    hypes["train_params"]["eval_freq"] = 4
    hypes["train_params"]["save_freq"] = 4
    cfg = str(tmp_path / "real.yaml")
    save_yaml(hypes, cfg)
    run_dir = port_train.main(["--hypes_yaml", cfg, "--log_dir", str(tmp_path),
                               "--epochs", "4", "--num_workers", "2",
                               "--device", "cpu"])
    lines = open(os.path.join(run_dir, "train_loss.txt")).read().splitlines()
    totals = [float(line.split("total_loss: ")[1].split()[0]) for line in lines]
    assert len(totals) == 4 and totals[-1] < totals[0], totals
    assert os.path.isfile(os.path.join(run_dir, "net_epoch4"))
    assert "epoch: 4, loss:" in open(
        os.path.join(run_dir, "validation_loss.txt")).read()
    synthetic = port_train.main(["--hypes_yaml", cfg, "--log_dir", str(tmp_path),
                                 "--epochs", "1", "--steps_per_epoch", "1",
                                 "--synthetic", "--device", "cpu"])
    assert os.path.isfile(os.path.join(synthetic, "train_loss.txt"))
