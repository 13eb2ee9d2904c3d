"""The port's camera data path against the JAX package's, on the CPU: each
function of ``data/camera.py`` exactly (the extrinsic conversions, the
CARLA depth codec, the augmentation draws, PIL's transforms with the
post-homography, the normalization, the slot stacking), one agent's
cameras loaded from the on-disk fixture (``tests/fixture_utils.py``,
``with_camera=True``), ``AirV2XDataset`` samples with ``cam_<type>`` blocks
(vehicle + RSU, and every type camera only) in train and eval over two
epochs, ``RealDataLoader`` batches, both packages' refusal of the shipped
camera YAMLs (their ``data_aug_conf`` gives only ``final_dim``), and the
det and seg evaluation CLIs of a camera-only model on the fixture, whose
tables must equal the JAX CLIs'.

The CLI configs move the tiny camera grid by ``chip_smoke.GRID_SHIFT``: the
fixture's cameras put frustum points on the unshifted grid's cell
boundaries (to within 1e-6 of a cell, and exactly in z), where the two
packages' geometry could round a point into neighbouring cells. The test
asserts that every point of the present agents lies more than CELL_MARGIN
of a cell from a boundary.
"""

import ast
import math
import os
import pickle

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.config import save_yaml as jax_save_yaml
from airv2x_tpu.data import camera as jcam
from airv2x_tpu.data.airv2x_dataset import AirV2XDataset as JaxDataset
from airv2x_tpu.data.loader import RealDataLoader as JaxLoader
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.parallel.train import create_train_state, make_optimizer
from airv2x_tpu.tools import inference_airv2x_seg as jax_seg_cli
from airv2x_tpu.tools import inference_multi_scenario as jax_multi
from airv2x_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data import camera as tcam
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.eval import ap
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.parallel.train import TrainState
from airv2x_tpu_torch.tools import inference_airv2x_seg, inference_multi_scenario
from airv2x_tpu_torch.utils.checkpoint import save_checkpoint
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.fixture_utils import (
    FIXTURE_AUG_CONF, FIXTURE_SEG_HW, cam_hypes, make_fixture)
from tests.test_torch_data import TARGET_TOL, assert_same_sample
from tests.torch_port_helpers import (
    CHIP_SMOKE, REPO, TINY, one_torch_thread, random_variables, tiny_seg)

AGENT_TYPES = ("vehicle", "rsu", "drone")
# the AirV2X camera values hypes_yaml/airv2x/lidar/det/bm2cp.yaml records
BM2CP_AUG = dict(CHIP_SMOKE.AIRV2X_AUG, final_dim=[256, 352])
# the camera YAMLs of ported models
SHIPPED = [f"hypes_yaml/airv2x/camera/{task}/{name}.yaml"
           for task, name in CHIP_SMOKE.CAMERA_PATHS]
CELL_MARGIN = 1e-4  # cell widths
IOU_MARGIN = 1e-4
CONF = 0.012863  # tests/test_torch_where2comm.py's near-constant confidence
OBJ_SHIFT = 3.0  # added to the objectness logits of the det CLI's model


@pytest.fixture(scope="module")
def cam_root(tmp_path_factory):
    return make_fixture(str(tmp_path_factory.mktemp("cam_fixture")),
                        n_timestamps=2, with_camera=True, with_seg=True)


def _agent_dir(root, t=0, aid=1):
    scen = os.path.join(root, sorted(os.listdir(root))[0])
    return os.path.join(scen, f"timestamp_{t:06d}", f"agent_{aid:06d}")


def _camera_only(hypes, use_depth_gt=False):
    """``cam_hypes`` on every type, each camera only (as the shipped camera
    YAMLs are)."""
    hypes = cam_hypes(hypes, AGENT_TYPES)
    for t in AGENT_TYPES:
        hypes["model"]["args"][t]["modalities"] = ["cam"]
        hypes["model"]["args"][t]["cam"]["use_depth_gt"] = use_depth_gt
    return hypes


# ---------------------------------------------------------------------------
# data/camera.py, function by function
# ---------------------------------------------------------------------------


def test_camera_constants_match_jax():
    assert tcam.CAM_KEYS == jcam.CAM_KEYS
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "_UE4_TO_LSS_R"):
        np.testing.assert_array_equal(getattr(tcam, name), getattr(jcam, name))
    assert tcam.DYNAMIC_SEG_FILES == jcam.DYNAMIC_SEG_FILES
    assert tcam.STATIC_SEG_FILES == jcam.STATIC_SEG_FILES


def test_ue4_lss_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(10):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        m = np.eye(4)
        m[:3, :3] = q * np.sign(np.linalg.det(q))
        m[:3, 3] = rng.uniform(-3, 3, 3)
        m = m.astype(np.float32)
        got, want = tcam.ue4_to_lss(m), jcam.ue4_to_lss(m)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tcam.lss_to_ue4(got), jcam.lss_to_ue4(want))
        np.testing.assert_allclose(tcam.lss_to_ue4(got), m, atol=1e-5)


def test_depth_codec_matches_jax(tmp_path):
    depth = np.random.default_rng(1).uniform(0, 1200, (20, 30)).astype(np.float32)
    enc = tcam.encode_depth_carla(depth)
    np.testing.assert_array_equal(enc, jcam.encode_depth_carla(depth))
    path = str(tmp_path / "d.png")
    Image.fromarray(enc).save(path)
    got = tcam.decode_depth_carla(path)
    np.testing.assert_array_equal(got, jcam.decode_depth_carla(path))
    np.testing.assert_allclose(got, np.minimum(depth, 1000.0), atol=1e-3)


AUG_CONFS = {"fixture": FIXTURE_AUG_CONF, "airv2x": BM2CP_AUG,
             "flip+rotate": dict(BM2CP_AUG, rand_flip=True, rot_lim=[-5.4, 5.4])}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("conf", sorted(AUG_CONFS))
def test_sample_augmentation_matches_jax(conf, train):
    """The same draws from one generator, in the same order, for 20
    cameras; eval is deterministic. The AirV2X values give the crop a top
    7 px above the image in eval."""
    c = AUG_CONFS[conf]
    rt, rj = np.random.default_rng(2), np.random.default_rng(2)
    outs = [tcam.sample_augmentation(c, train, rt) for _ in range(20)]
    assert outs == [jcam.sample_augmentation(c, train, rj) for _ in range(20)]
    assert rt.random() == rj.random()  # the generators advanced alike
    if conf == "airv2x" and not train:
        resize, dims, crop, flip, rot = outs[0]
        assert dims == (455, 256) and crop == (51, -7, 403, 249)
    if conf == "flip+rotate" and train:
        assert {o[3] for o in outs} == {True, False}
        assert all(o[4] != 0 for o in outs)


def test_sample_augmentation_names_the_missing_keys():
    conf = {"final_dim": [256, 352]}  # the shipped camera YAMLs' aug conf
    with pytest.raises(KeyError, match="H"):
        jcam.sample_augmentation(conf, False)
    with pytest.raises(KeyError) as err:
        tcam.sample_augmentation(conf, False)
    assert all(k in str(err.value) for k in tcam.AUG_KEYS)


@pytest.mark.parametrize("case", ["eval, negative crop_h", "flip", "rotate"])
def test_img_transform_matches_jax(case):
    """An RGB and a 16-bit depth image through the same PIL calls: the
    pixels and the post-homography equal; with the crop above the image the
    top rows are zeros and ``post_tran`` carries the offset."""
    rng = np.random.default_rng(3)
    rgb = Image.fromarray(rng.integers(0, 255, (72, 128, 3), dtype=np.uint8))
    depth = Image.fromarray(rng.integers(0, 65535, (72, 128)).astype(np.uint16))
    conf = dict(BM2CP_AUG, H=72, W=128, final_dim=[32, 48])
    aug = list(jcam.sample_augmentation(conf, False))
    if case == "flip":
        aug[3] = True
    elif case == "rotate":
        aug[4] = 7.5
    got = tcam.img_transform([rgb, depth], *aug)
    want = jcam.img_transform([rgb, depth], *aug)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if case.startswith("eval"):
        crop_h = aug[2][1]
        assert crop_h < 0 and got[2][1] == -crop_h
        assert not np.asarray(got[0][0])[:-crop_h].any()


def test_normalize_img_matches_jax():
    img = Image.fromarray(np.random.default_rng(4).integers(
        0, 255, (9, 13, 3), dtype=np.uint8))
    got = tcam.normalize_img(img)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jcam.normalize_img(img))


def test_stack_cam_slots_matches_jax():
    rng = np.random.default_rng(5)

    def cam(n):
        return {"imgs": rng.normal(size=(n, 4, 6, 3)).astype(np.float32),
                "intrinsics": rng.normal(size=(n, 3, 3)).astype(np.float32),
                "rots": rng.normal(size=(n, 3, 3)).astype(np.float32),
                "trans": rng.normal(size=(n, 3)).astype(np.float32),
                "post_rots": rng.normal(size=(n, 3, 3)).astype(np.float32),
                "post_trans": rng.normal(size=(n, 3)).astype(np.float32)}

    slots = {1: cam(2), 3: cam(2)}
    got, want = tcam.stack_cam_slots(slots, 5), jcam.stack_cam_slots(slots, 5)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["rots"][0], np.broadcast_to(np.eye(3), (2, 3, 3)))
    assert not got["imgs"][0].any() and not got["trans"][4].any()
    slots[4] = cam(1)
    for mod in (tcam, jcam):
        with pytest.raises(ValueError, match="same number of cameras"):
            mod.stack_cam_slots(slots, 5)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("with_depth", [True, False], ids=["depth", "rgb"])
def test_load_agent_cam_inputs_matches_jax(cam_root, with_depth, train):
    """One vehicle's and one RSU's cameras from disk, every array equal;
    with depth the 4th channel is the fixture's 10 m through the 16-bit
    round trip. A camera missing on disk is skipped."""
    for aid, atype in ((1, "vehicle"), (3, "rsu")):
        adir = _agent_dir(cam_root, aid=aid)
        with open(os.path.join(adir, "metadata.pkl"), "rb") as f:
            meta = pickle.load(f)
        args = (adir, meta, atype, FIXTURE_AUG_CONF, train)
        got = tcam.load_agent_cam_inputs(*args, np.random.default_rng(6),
                                         with_depth=with_depth)
        want = jcam.load_agent_cam_inputs(*args, np.random.default_rng(6),
                                          with_depth=with_depth)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["imgs"].shape == (2, 32, 48, 4 if with_depth else 3)
        if with_depth:
            d = got["imgs"][..., 3]
            assert np.abs(d[d > 0] - 10.0).max() < 0.02
    # an agent without cameras on disk
    assert tcam.load_agent_cam_inputs(str(cam_root), {}, "drone",
                                      FIXTURE_AUG_CONF, False) is None


# ---------------------------------------------------------------------------
# The dataset and the loader
# ---------------------------------------------------------------------------

CAM_KINDS = {"vehicle+rsu": lambda h: cam_hypes(h, ("vehicle", "rsu")),
             "camera only": _camera_only}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("kind", sorted(CAM_KINDS))
def test_dataset_camera_samples_match_jax(cam_root, kind, train):
    """Every ``cam_<type>`` leaf equal to JAX's, the clouds within
    CLOUD_TOL, over the samples and two epochs (the train draws move with
    the epoch)."""
    hypes = [CAM_KINDS[kind](load(TINY)) for load in (jax_load_yaml, load_yaml)]
    for h in hypes:
        h["preprocess"]["max_points"] = 1024
    ds_j = JaxDataset(hypes[0], cam_root, train=train, seed=7)
    ds_t = AirV2XDataset(hypes[1], cam_root, train=train, seed=7)
    posts = set()
    for idx in range(len(ds_t)):
        for epoch in (0, 1):
            got = ds_t.__getitem__(idx, epoch=epoch)
            assert_same_sample(ds_j.__getitem__(idx, epoch=epoch), got,
                               f"{kind} train={train} sample {idx} epoch {epoch}")
            types = {k for k in got[0] if k.startswith("cam_")}
            assert types == ({"cam_vehicle", "cam_rsu"} if kind == "vehicle+rsu"
                             else {"cam_vehicle", "cam_rsu", "cam_drone"})
            cam = got[0]["cam_vehicle"]
            assert cam["imgs"].shape == (4, 2, 32, 48, 4 if kind == "vehicle+rsu"
                                         else 3)
            posts.add(cam["post_trans"][0, 0].tobytes())
    assert (len(posts) > 1) == train


def test_loader_batches_carry_cameras(cam_root):
    """``RealDataLoader`` stacks the camera blocks leaf by leaf, as the JAX
    loader does."""
    hypes = [_camera_only(load(TINY)) for load in (jax_load_yaml, load_yaml)]
    kw = dict(batch_size=2, train=True, seed=3, num_workers=2)
    lj = JaxLoader(JaxDataset(hypes[0], cam_root, seed=3), hypes[0], **kw)
    lt = RealDataLoader(AirV2XDataset(hypes[1], cam_root, seed=3), hypes[1],
                        device="cpu", **kw)
    for (bj, gj), (bt, gt) in zip(lj.batches(0, with_gt=True),
                                  lt.batches(0, with_gt=True)):
        lab_j, lab_t = bj.pop("labels"), bt.pop("labels")
        assert isinstance(bt["cam_drone"]["imgs"], torch.Tensor)
        assert bt["cam_vehicle"]["imgs"].shape == (2, 4, 2, 32, 48, 3)
        host = {k: ({kk: vv.numpy() for kk, vv in v.items()} if isinstance(v, dict)
                    else v.numpy()) for k, v in bt.items()}
        assert_same_sample((bj, gj), (host, gt), "camera batch")
        np.testing.assert_allclose(lab_t["targets"].numpy(), np.asarray(
            lab_j["targets"]), rtol=TARGET_TOL, atol=TARGET_TOL)


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.split("camera/")[1])
def test_shipped_camera_yamls_are_refused_by_both(cam_root, path):
    """Every camera YAML of a ported model gives ``data_aug_conf`` only
    ``final_dim``: both packages' datasets raise KeyError on ``H`` at the
    first camera read, and neither adds a default. The model builds (CoBEVT
    with the slot count as its agent_size)."""
    full = os.path.join(REPO, path)
    hypes = load_yaml(full)
    assert set(hypes["model"]["args"]["vehicle"]["cam"]["data_aug_conf"]) == {
        "final_dim"}
    for load, dataset in ((jax_load_yaml, JaxDataset), (load_yaml, AirV2XDataset)):
        ds = dataset(load(full), cam_root, train=False)
        with pytest.raises(KeyError, match="H"):
            ds[0]
    model = build_model(hypes, device="cpu")
    assert model.task == hypes["model"]["args"]["task"]
    fax = hypes["model"]["args"].get("fax_fusion")
    if fax:  # CoBEVT: agent_size is the slot count, 15 for max_cav 5 / 5 / 5
        ws = fax["window_size"]
        table = next(p for n, p in model.named_parameters()
                     if n.endswith("relative_position_bias"))
        assert model.layout.total == 15
        assert table.shape[0] == (2 * 15 - 1) * (2 * ws - 1) ** 2


# ---------------------------------------------------------------------------
# The evaluation CLIs on the camera fixture
# ---------------------------------------------------------------------------


def _cli_hypes(load, seg):
    """The tiny config with the vehicles alone, camera only, the grid moved
    by ``chip_smoke.GRID_SHIFT`` (det; or seg at the fixture's label size).
    One camera type keeps the JAX CLIs' compilation short."""
    hypes = _camera_only(load(TINY))
    hypes["model"]["args"]["collaborators"] = ["vehicle"]
    if seg:
        tiny_seg(hypes)
        hypes["seg_hw"] = hypes["model"]["args"]["seg_hw"] = FIXTURE_SEG_HW
    return CHIP_SMOKE.shift_camera_grid(hypes)


def _run_dirs(tmp, seg, sample):
    """A JAX and a port run dir holding one seeded tiny camera model as
    epoch 1 (its flax variables shaped by ``sample``)."""
    hypes = _cli_hypes(jax_load_yaml, seg)
    jmodel = jax_build_model(hypes)
    example = jax.tree.map(lambda v: jax.numpy.asarray(v)[None], sample)
    var = random_variables(jmodel, example, seed=8, train=False)
    if not seg:  # a near-constant confidence: the comm mask far from 0.01
        cls = var["params"]["heads"]["cls_head"]
        cls["kernel"] = cls["kernel"] * np.float32(1e-3)
        cls["bias"] = np.full_like(cls["bias"], math.log(CONF / (1 - CONF)))
        # most anchors past the objectness gate, ranked by the features
        obj = var["params"]["heads"]["obj_head"]
        obj["bias"] = obj["bias"] + np.float32(OBJ_SHIFT)
    jax_dir, port_dir = str(tmp / "jax"), str(tmp / "port")
    os.makedirs(jax_dir)
    os.makedirs(port_dir)
    jax_save_yaml(hypes, os.path.join(jax_dir, "config.yaml"))
    tx, _ = make_optimizer(hypes)
    jax_save_checkpoint(jax_dir, 1, jax.device_get(
        create_train_state(jmodel, jax.tree.map(jax.numpy.asarray, var), tx)))
    phypes = _cli_hypes(load_yaml, seg)
    save_yaml(phypes, os.path.join(port_dir, "config.yaml"))
    model = build_model(phypes, device="cpu")
    load_flax_variables(model, var)
    save_checkpoint(port_dir, 1, TrainState(
        model, torch.optim.SGD(model.parameters(), lr=0.0)))
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def cli_samples(cam_root):
    """Per task, the camera fixture's first eval sample (model inputs),
    every sample's frustum margin asserted."""
    first = {}
    for seg in (False, True):
        hypes = _cli_hypes(load_yaml, seg)
        ds = AirV2XDataset(hypes, cam_root, train=False)
        for i in range(len(ds)):
            batch, _ = ds[i]
            assert CHIP_SMOKE.camera_frustum_margin(hypes, batch) > CELL_MARGIN
        first[seg] = {k: v for k, v in ds[0][0].items()
                      if not k.endswith("_seg_label")}
    return first


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


def _table(path):
    with open(path) as f:
        return {name.strip(): ast.literal_eval(payload.strip())
                for name, payload in (line.split(":", 1) for line in f)}


class _Block(dict):
    """A ``cam_<type>`` block that ``[None]`` batches leaf by leaf."""

    def __getitem__(self, key):
        if key is None:
            return {k: v[None] for k, v in self.items()}
        return super().__getitem__(key)


_ASARRAY = jax.numpy.asarray


def _nested_asarray(v, *args, **kwargs):
    """``jnp.asarray`` that also takes a camera block (the JAX seg CLI's
    ``to_model_batch`` passes each sample value through it, camera blocks
    included, which jnp.asarray refuses: ROADMAP §3)."""
    if isinstance(v, dict):
        return _Block({k: _ASARRAY(x) for k, x in v.items()})
    return _ASARRAY(v, *args, **kwargs)


@pytest.mark.parametrize("task", ["det", "seg"])
def test_camera_cli_matches_jax(cam_root, cli_samples, tmp_path, monkeypatch,
                                ap_ious, task):
    """``inference_multi_scenario`` (det) and ``inference_airv2x_seg`` (seg)
    of the port and the JAX package on the camera fixture, from one set of
    variables: the same tables."""
    seg = task == "seg"
    jax_dir, port_dir = _run_dirs(tmp_path, seg, cli_samples[seg])
    argv = ["--test_dir", cam_root]
    jax_main, port_main = ((jax_seg_cli.main, inference_airv2x_seg.main) if seg
                           else (jax_multi.main, inference_multi_scenario.main))
    monkeypatch.setattr("sys.argv", ["prog", "--model_dir", jax_dir] + argv)
    with monkeypatch.context() as mp:
        if seg:  # the JAX seg CLI batches each input with jnp.asarray(v)[None]
            mp.setattr(jax.numpy, "asarray", _nested_asarray)
        jax_main()
    got = port_main(["--model_dir", port_dir, "--device", "cpu"] + argv)
    if seg:
        texts = [open(os.path.join(d, "results_seg.txt")).read()
                 for d in (jax_dir, port_dir)]
        assert texts[0] == texts[1]
        yamls = [jax_load_yaml(os.path.join(d, "eval_seg_epoch1.yaml"))
                 for d in (jax_dir, port_dir)]
        assert yamls[0]["dynamic"] == yamls[1]["dynamic"]
        assert yamls[0]["static"] == yamls[1]["static"]
        assert got["num_samples"] == 2
        return
    assert ap_ious, "the AP computed no IoU"
    for iou in ap_ious:
        for t in ap.IOU_THRESHOLDS:
            assert np.abs(iou - t).min() > IOU_MARGIN, f"an IoU near {t}"
    want = _table(os.path.join(jax_dir, "results.txt"))
    table = _table(os.path.join(port_dir, "results.txt"))
    assert set(table) == set(want) and "COMBINED" in table
    for name in want:
        rate = table[name].pop("comm_rate", None)
        assert rate == pytest.approx(want[name].pop("comm_rate", None), abs=1e-6)
        assert table[name] == want[name], name
    assert got["COMBINED"]["ap_30"] == table["COMBINED"]["ap_30"]
