"""BM2CP's inputs on disk in the PyTorch port against the JAX package: the
LiDAR-depth projection (``depth_discretization_np``,
``project_lidar_depth_map``, ``load_agent_depth_maps``) bit for bit; the
AirV2X dataset's BM2CP branch (veh / rsu ``img_params``, the drone's flat
LSS conf, each with its agent's LiDAR projected into its cameras) on the
camera fixture (``tests/fixture_utils.py:make_fixture``); the OPV2V camera
branch on the OPV2V fixture with two cameras per cav frame written in; the
DAIR camera block on the raw fixture with its camera calibration.
"""

import copy
import os
import pickle

import jax
import numpy as np
import pytest
import yaml
from PIL import Image

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data import camera as jcam
from airv2x_tpu.data.airv2x_dataset import AirV2XDataset as JaxDataset
from airv2x_tpu.data.opv2v_dataset import OPV2VDataset as JaxOPV2V
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data import camera as tcam
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
from tests.fixture_utils import FIXTURE_AUG_CONF, lss_to_ue4, make_fixture
from tests.test_opv2v_dataset import _fixture as opv2v_fixture
from tests.test_torch_data import assert_same_sample
from tests.test_torch_opv2v_data import hypes as opv2v_hypes
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread  # noqa: F401


@pytest.mark.parametrize("mode", ["UD", "LID"])
def test_depth_discretization_matches_jax(mode):
    np.testing.assert_array_equal(tcam.depth_discretization_np(2, 50, 48, mode),
                                  jcam.depth_discretization_np(2, 50, 48, mode))


@pytest.mark.parametrize("final_hw", [(64, 96), (16, 24), (20, 30)],
                         ids=["full", "pooled", "nearest"])
def test_project_lidar_depth_map_same_bits(final_hw):
    """A cloud around a camera (points behind it, beyond the image, on
    shared pixels) projected at full, min-pooled and nearest-sampled
    resolution: the same bits as the JAX package's."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-30, 30, (5000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 3, 5000)
    pts = np.concatenate([pts, np.repeat(pts[:50], 3, axis=0)])  # shared pixels
    h, w = 64, 96
    intr = np.array([[w * 0.8, 0, w / 2], [0, w * 0.8, h / 2], [0, 0, 1]])
    c2l = np.eye(4)
    c2l[:3, :3] = [[0, 0, 1], [-1, 0, 0], [0, -1, 0]]
    c2l[:3, 3] = [0.5, 0.2, 1.5]
    extr = lss_to_ue4(c2l)
    dd = jcam.depth_discretization_np(2, 50, 8, "LID")
    want = jcam.project_lidar_depth_map(pts, intr, extr, (h, w), dd, final_hw)
    got = tcam.project_lidar_depth_map(pts, intr, extr, (h, w), dd, final_hw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).any() and (want == -1).any()
    empty = tcam.project_lidar_depth_map(np.zeros((0, 3), np.float32), intr,
                                         extr, (h, w), dd, final_hw)
    assert (empty == -1).all()


# --- the AirV2X dataset's BM2CP branch ----------------------------------------


@pytest.fixture(scope="module")
def cam_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("bm2cp_fixture")),
                        n_timestamps=2, with_camera=True)


def bm2cp_hypes(load):
    """The tiny BM2CP config on the fixture's images (its aug conf)."""
    h = CHIP_SMOKE.tiny_bm2cp_hypes(load(TINY))
    args = h["model"]["args"]
    for conf in (args["vehicle"]["img_params"], args["rsu"]["img_params"],
                 args["drone"]):
        conf["data_aug_conf"] = dict(FIXTURE_AUG_CONF)
    h["preprocess"]["max_points"] = 1024
    return h


def test_load_agent_depth_maps_same_bits(cam_root):
    """One fixture agent's cloud projected into its cameras through a
    cav -> points transform (``proj_first``)."""
    scen = os.path.join(cam_root, sorted(os.listdir(cam_root))[0])
    adir = os.path.join(scen, "timestamp_000000", "agent_000001")
    with open(os.path.join(adir, "metadata.pkl"), "rb") as f:
        meta = pickle.load(f)
    rng = np.random.default_rng(4)
    pts = rng.uniform(-15, 15, (3000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-2, 2, 3000)
    t = np.eye(4)
    t[:3, 3] = [1.5, -0.7, 0.1]
    grid = CHIP_SMOKE.TINY_BM2CP_IMG["grid_conf"]
    args = ("vehicle", pts, grid, (32, 48))
    want = jcam.load_agent_depth_maps(adir, meta, *args, cav_to_points=t)
    got = tcam.load_agent_depth_maps(adir, meta, *args, cav_to_points=t)
    np.testing.assert_array_equal(got, want)
    assert want.shape[1:] == (32, 48) and (want >= 0).any()
    assert tcam.load_agent_depth_maps(str(cam_root), {}, "drone", pts, grid,
                                      (32, 48)) is None


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dataset_bm2cp_samples_match_jax(cam_root, train):
    """Every sample and two epochs: the camera blocks of the three types
    and the vehicle and rsu ``depth_maps`` equal to JAX's, the clouds within
    the PCD readers' tolerance; the projected returns fill some pixels of
    the present agents' maps and none of the empty slots'."""
    ds_j = JaxDataset(bm2cp_hypes(jax_load_yaml), cam_root, train=train, seed=7)
    ds_t = AirV2XDataset(bm2cp_hypes(load_yaml), cam_root, train=train, seed=7)
    assert ds_t.bm2cp and set(ds_t.cam_grid) == {"vehicle", "rsu", "drone"}
    for idx in range(len(ds_t)):
        for epoch in (0, 1):
            got = ds_t.__getitem__(idx, epoch=epoch)
            assert_same_sample(ds_j.__getitem__(idx, epoch=epoch), got,
                               f"train={train} sample {idx} epoch {epoch}")
            batch = got[0]
            assert {k for k in batch if k.startswith("cam_")} == {
                "cam_vehicle", "cam_rsu", "cam_drone"}
            dm = batch["cam_vehicle"]["depth_maps"]
            assert dm.shape[-2:] == (32, 48) and (dm >= 0).any()
            present = batch["agent_mask"].copy()
            assert (dm[~present[:dm.shape[0]]] == -1).all()


# --- the OPV2V camera branch and the DAIR camera block ---------------------------


@pytest.fixture(scope="module")
def opv2v_root(tmp_path_factory):
    """The JAX tests' OPV2V fixture with two cameras in every cav frame
    (tests/test_opv2v_dataset.py:test_opv2v_camera_loading's rig)."""
    root = str(tmp_path_factory.mktemp("opv2v_cam"))
    opv2v_fixture(root, np.random.default_rng(0))
    rng = np.random.default_rng(5)
    scen = os.path.join(root, "2021_08_16_01_01_01")
    h, w = 64, 96
    intr = [[w * 0.8, 0, w / 2], [0, w * 0.8, h / 2], [0, 0, 1]]
    for cav in sorted(os.listdir(scen)):
        for t in ("000068", "000070"):
            ypath = os.path.join(scen, cav, f"{t}.yaml")
            with open(ypath) as f:
                meta = yaml.safe_load(f)
            for i in range(2):
                Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
                    os.path.join(scen, cav, f"{t}_camera{i}.png"))
                pose = list(meta["lidar_pose"])
                pose[2] += 0.5
                pose[4] += 90.0 * i
                meta[f"camera{i}"] = {"cords": pose, "intrinsic": intr}
            with open(ypath, "w") as f:
                yaml.safe_dump(meta, f)
    return root


def opv2v_cam_hypes():
    h = opv2v_hypes()
    h["model"]["args"]["vehicle"] = {"modalities": ["lidar", "cam"], "cam": {
        "data_aug_conf": dict(FIXTURE_AUG_CONF, H=64, W=96)}}
    return h


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_opv2v_camera_samples_match_jax(opv2v_root, train):
    """``cam_vehicle`` of every sample equal to JAX's (both cameras of each
    present cav, identity-filled empty slots), two epochs."""
    ds_j = JaxOPV2V(opv2v_cam_hypes(), opv2v_root, train=train, seed=3)
    ds_t = OPV2VDataset(opv2v_cam_hypes(), opv2v_root, train=train, seed=3)
    for idx in range(len(ds_t)):
        for epoch in (0, 1):
            got = ds_t.__getitem__(idx, epoch=epoch)
            assert_same_sample(ds_j.__getitem__(idx, epoch=epoch), got,
                               f"train={train} sample {idx} epoch {epoch}")
            cam = got[0]["cam_vehicle"]
            assert cam["imgs"].shape[1:] == (2, 32, 48, 3)
            assert np.abs(cam["rots"][0, 0] - np.eye(3)).max() > 0.1


def test_bm2cp_yamls_load_no_opv2v_camera(opv2v_root):
    """The ``opv2v_bm2cp`` YAML keeps its camera block under ``img_params``,
    which neither package's OPV2V loader reads (ROADMAP §3): no
    ``cam_vehicle`` in either's sample."""
    path = os.path.join(os.path.dirname(TINY), "..", "opv2v", "opv2v_bm2cp.yaml")
    samples = []
    for load, ds in ((jax_load_yaml, JaxOPV2V), (load_yaml, OPV2VDataset)):
        h = copy.deepcopy(load(path))
        h["preprocess"]["max_points"] = 2048
        samples.append(ds(h, opv2v_root, train=False)[0][0])
    assert all("cam_vehicle" not in s for s in samples)
    assert jax.tree.structure(samples[0]) == jax.tree.structure(samples[1])


def test_train_and_eval_clis_serve_bm2cp_on_disk(cam_root, tmp_path):
    """The tiny BM2CP config trained one step on the camera fixture through
    ``tools/train.py`` (its dataset's BM2CP branch, the depth maps
    projected per sample), then scored by ``inference_multi_scenario`` from
    that run dir: finite loss and a finite AP table. Without a dataset the
    CLI refuses BM2CP before it makes a run dir."""
    from airv2x_tpu_torch.tools import inference_multi_scenario
    from airv2x_tpu_torch.tools import train as train_cli
    from airv2x_tpu_torch.utils.checkpoint import find_last_epoch

    hypes = bm2cp_hypes(load_yaml)
    hypes["root_dir"] = hypes["validate_dir"] = hypes["test_dir"] = str(cam_root)
    cfg = str(tmp_path / "cfg.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(jax.tree.map(lambda v: v.tolist() if hasattr(v, "tolist")
                                    else v, hypes), f)
    run_dir = train_cli.main(["--hypes_yaml", cfg, "--device", "cpu", "--log_dir",
                              str(tmp_path / "logs"), "--epochs", "1",
                              "--steps_per_epoch", "1", "--num_workers", "1"])
    assert find_last_epoch(run_dir) == 1
    with open(os.path.join(run_dir, "train_loss.txt")) as f:
        line = f.read()
    assert "total_loss" in line and "nan" not in line
    out = inference_multi_scenario.main(["--model_dir", run_dir, "--device", "cpu"])
    assert all(np.isfinite(v) for v in jax.tree.leaves(out)
               if isinstance(v, (int, float)))
    with pytest.raises(NotImplementedError, match="BM2CP"):
        train_cli.main(["--hypes_yaml", cfg, "--device", "cpu", "--synthetic",
                        "--log_dir", str(tmp_path / "logs2")])
    assert not (tmp_path / "logs2").exists()
