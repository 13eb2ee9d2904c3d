"""The OPV2V data path of the port against the JAX package on the CPU:
``OPV2VDataset`` samples, ``RealDataLoader`` batches over them (the time
axis included), the refusals, and the SCOPE contract on a loaded temporal
batch, with one SCOPE train step on it.

Both packages read tests/test_opv2v_dataset.py's fixture (two cavs 20 m
apart, two timestamps, one object in range and one far out) with two more
cavs: one 50 m from the ego and one beyond the 70 m communication range,
which the gate drops. The JAX dataset reads PCD files through its native C
reader where it builds; the port through numpy: the clouds are compared
within CLOUD_TOL and every transformed point is asserted to lie more than
CROP_MARGIN from the range crop (tests/test_torch_data.py). The configs
are the tiny SCOPE config's grid (``chip_smoke.tiny_scope_hypes``).

SCOPE reads ``pairwise_t_full`` as (B, T, L, L, 4, 4), but both packages'
OPV2V datasets give the current frame's (L, L, 4, 4) only, so both models
refuse a loaded batch as it is (ROADMAP §3). ``pairwise_over_frames``
repeats it over the frames, which is exact under ``proj_first``: every
entry is the identity. The train step is held to JAX's float64 step: JAX's
own f32 loss lies 1.3e-5 (relative) from it on this batch, beyond the
step tolerance, the port's f32 within 1e-7.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from airv2x_tpu.data.airv2x_dataset import WildSettings as JaxWild
from airv2x_tpu.data.loader import RealDataLoader as JaxLoader
from airv2x_tpu.data.opv2v_dataset import OPV2VDataset as JaxOPV2V
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch.data import opv2v_dataset as port_opv2v
from airv2x_tpu_torch.data.airv2x_dataset import WildSettings
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.data.opv2v_dataset import (
    OPV2VDataset, pairwise_over_frames)
from airv2x_tpu_torch.data.pcd import write_pcd
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_opv2v_dataset import _fixture
from tests.test_torch_data import (
    CROP_MARGIN, assert_same_sample, record_crop_margins)
from tests.torch_port_helpers import CHIP_SMOKE, one_torch_thread, random_variables
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    port_step, twin)

EXTRA_CAVS = {"660": [55.0, 25.0, 1.9, 0, -20.0, 0],  # 50 m from the ego
              "900": [150.0, 5.0, 1.9, 0, 0, 0]}  # beyond the 70 m gate
TARGET_TOL = 1e-6  # anchor targets (tests/test_torch_data.py)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The JAX tests' fixture plus two cavs, each with the first cav's
    objects, its own cloud and pose and an object of its own."""
    root = str(tmp_path_factory.mktemp("opv2v"))
    _fixture(root, np.random.default_rng(0))
    scen = os.path.join(root, "2021_08_16_01_01_01")
    rng = np.random.default_rng(1)
    for cav, pose in EXTRA_CAVS.items():
        os.makedirs(os.path.join(scen, cav))
        for t in ("000068", "000070"):
            with open(os.path.join(scen, "641", f"{t}.yaml")) as f:
                meta = yaml.safe_load(f)
            meta["lidar_pose"] = list(pose)
            meta["ego_speed"] = 3.25
            meta["vehicles"][int(cav)] = {
                "location": [18.0, 6.0, 0.4], "angle": [0, -30.0, 0],
                "center": [0.0, 0.0, 0.4], "extent": [2.0, 0.9, 0.8]}
            with open(os.path.join(scen, cav, f"{t}.yaml"), "w") as f:
                yaml.safe_dump(meta, f)
            pts = rng.normal(scale=15.0, size=(400, 4)).astype(np.float32)
            pts[:, 2] = rng.uniform(-1.5, 0.5, 400) - 1.9
            write_pcd(os.path.join(scen, cav, f"{t}.pcd"), pts)
    # an ``additional`` yaml the walk skips
    with open(os.path.join(scen, "641", "000068_additional.yaml"), "w") as f:
        yaml.safe_dump({"note": 1}, f)
    return root


def hypes(frames=1, max_cav=4, proj_first=True):
    """The tiny SCOPE config's grid as an OPV2V config: ``frames`` > 1 makes
    it SCOPE's temporal config, else the flat ``point_pillar``."""
    h = CHIP_SMOKE.tiny_scope_hypes()
    h["train_params"] = {"max_cav": max_cav, "batch_size": 2}
    h["model"]["args"]["max_cav"] = max_cav
    h["preprocess"]["max_points"] = 2048
    h["postprocess"]["target_args"].update(pos_threshold=0.6, neg_threshold=0.45)
    h["fusion"] = {"args": {"proj_first": proj_first}}
    if frames > 1:
        h["model"]["args"]["temporal_fusion"] = {"frames": frames}
    else:
        h["model"]["core_method"] = "point_pillar"
    h["loss"] = {"core_method": "point_pillar_loss",
                 "args": {"cls_weight": 1.0, "reg": 2.0}}
    h["optimizer"] = {"core_method": "Adam", "lr": 0.002,
                      "args": {"eps": 1e-10, "weight_decay": 1e-4}}
    h["lr_scheduler"] = {"core_method": "multistep", "gamma": 0.1,
                         "step_size": [15, 30]}
    return h


@pytest.fixture
def crop_margins(monkeypatch):
    return record_crop_margins(monkeypatch, port_opv2v)


# (hypes kwargs, dataset kwargs, epoch): every sample of each is compared
SAMPLES = {
    "single": (dict(), dict(train=False), 0),
    "temporal": (dict(frames=2), dict(train=False), 0),
    "wild": (dict(), dict(train=True, seed=4,
                          wild=dict(loc_error=True, xyz_std=1.0, ryp_std=2.0)), 1),
    "nearest-2": (dict(max_cav=2), dict(train=False), 0),
    "no-proj-first": (dict(proj_first=False), dict(train=False), 0),
}


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_dataset_matches_jax(root, crop_margins, kind):
    hkw, dkw, epoch = SAMPLES[kind]
    dkw = dict(dkw)
    wild = dkw.pop("wild", None)
    jds = JaxOPV2V(hypes(**hkw), root,
                   wild=JaxWild(**wild) if wild else None, **dkw)
    tds = OPV2VDataset(hypes(**hkw), root,
                       wild=WildSettings(**wild) if wild else None, **dkw)
    assert len(tds) == len(jds) == 2 and tds.frames == jds.frames
    for i in range(len(tds)):
        want = jds.__getitem__(i, epoch=epoch)
        got = tds.__getitem__(i, epoch=epoch)
        assert_same_sample(want, got, f"{kind} sample {i}")
        b = got[0]
        agents = b["agent_mask"][-1] if b["agent_mask"].ndim == 2 else b["agent_mask"]
        # the cav beyond 70 m never enters; nearest-2 keeps the ego and 650
        assert int(agents.sum()) == (2 if kind == "nearest-2" else 3), kind
        # 301 in range, 302 far out; 660's own object where 660 is chosen
        assert got[1]["mask"].sum() == (1 if kind == "nearest-2" else 2)
    # untransformed clouds (no proj_first) read bit for bit in both
    if hkw.get("proj_first", True):
        assert crop_margins and min(crop_margins) > CROP_MARGIN
    if kind == "temporal":
        assert b["points"].shape == (2, 4, 2048, 4)
        np.testing.assert_allclose(b["history_t"][-1], np.eye(4), atol=1e-6)
    if kind == "no-proj-first":
        assert np.abs(b["pairwise_t"][1] - np.eye(4)).max() > 1.0
    if kind == "wild":  # the noise moved the non-ego clouds of both
        clean = OPV2VDataset(hypes(), root, train=True, seed=4).__getitem__(
            1, epoch=1)[0]
        m = clean["points_mask"][1] & b["points_mask"][1]
        assert np.abs(clean["points"][1][m] - b["points"][1][m]).max() > 0.05
        np.testing.assert_array_equal(clean["points"][0], b["points"][0])


def test_dataset_refusals(root):
    """The camera branch, the radar branch and the MDD clean-point mask
    build (tests/test_torch_bm2cp_data.py, tests/test_torch_v2xr_data.py
    and tests/test_torch_mdd.py hold their samples); eval reads no mask."""
    cam = hypes()
    cam["model"]["args"]["vehicle"] = {"modalities": ["lidar", "cam"],
                                       "cam": {"data_aug_conf": {}}}
    assert OPV2VDataset(cam, root).cam_conf == {}
    radar = OPV2VDataset(hypes(), root, use_radar=True)
    assert len(radar) == 2 and radar.use_radar
    assert radar[0][0]["radar_points"].shape == (4, 2048 // 4, 4)
    mdd = hypes()
    mdd["model"]["core_method"] = "point_pillar_mdd"
    assert OPV2VDataset(mdd, root, train=True).with_de
    assert not OPV2VDataset(mdd, root, train=False).with_de  # eval reads no mask
    assert len(JaxOPV2V(hypes(), root, use_radar=True)) == 2


def _labels_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        if k == "targets":
            np.testing.assert_allclose(g, w, rtol=TARGET_TOL, atol=TARGET_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("frames", [1, 2])
def test_loader_matches_jax(root, frames):
    """Two epochs of shuffled batches of 2: every key (the time axis of a
    temporal batch included), the gt and the anchor labels of the current
    frame's gt."""
    kw = dict(batch_size=2, train=True, seed=3, num_workers=2)
    lj = JaxLoader(JaxOPV2V(hypes(frames), root, seed=3), hypes(frames), **kw)
    lt = RealDataLoader(OPV2VDataset(hypes(frames), root, seed=3), hypes(frames),
                        device="cpu", **kw)
    assert len(lt) == len(lj) == 1
    for epoch in (0, 1):
        assert lt.epoch_indices(epoch) == lj.epoch_indices(epoch)
        for (bj, gj), (bt, gt) in zip(lj.batches(epoch, with_gt=True),
                                      lt.batches(epoch, with_gt=True)):
            lab_j, lab_t = bj.pop("labels"), bt.pop("labels")
            assert_same_sample((bj, gj), ({k: v.numpy() for k, v in bt.items()},
                                          gt), f"frames {frames} epoch {epoch}")
            _labels_equal(lab_t, lab_j)
            assert lab_t["pos_equal_one"].sum() > 0
            assert bt["points"].shape == ((2, frames, 4, 2048, 4) if frames > 1
                                          else (2, 4, 2048, 4))


# --- SCOPE on a loaded temporal batch ------------------------------------------


@pytest.fixture(scope="module")
def scope_batch(root):
    """One loaded temporal batch of 2 (numpy, labels included) and its
    pairwise transforms repeated over the frames."""
    h = hypes(2)
    loader = JaxLoader(JaxOPV2V(h, root, seed=3), h, 2, train=True, seed=3,
                       num_workers=1)
    raw, _ = loader._collate([loader._sample(i, 0) for i in range(2)])
    raw = jax.tree.map(np.asarray, raw)
    return raw, pairwise_over_frames(raw)


@pytest.fixture(scope="module")
def scope_variables(scope_batch):
    scene = {k: v for k, v in scope_batch[1].items() if k != "labels"}
    return random_variables(jax_build_model(hypes(2)),
                            jax.tree.map(jnp.asarray, scene), seed=5, train=False)


def test_scope_refuses_the_raw_batch_in_both_packages(scope_batch, scope_variables):
    """The loaded batch as both datasets give it: JAX's SCOPE fails inside
    its warp (a vmap over mismatched axes), the port's says what to pass."""
    raw, fixed = scope_batch
    assert raw["pairwise_t_full"].shape == (2, 4, 4, 4, 4)
    assert fixed["pairwise_t_full"].shape == (2, 2, 4, 4, 4, 4)
    np.testing.assert_array_equal(  # proj_first: every entry the identity
        fixed["pairwise_t_full"], np.broadcast_to(np.eye(4, dtype=np.float32),
                                                  (2, 2, 4, 4, 4, 4)))
    scene = {k: v for k, v in raw.items() if k != "labels"}
    model = jax_build_model(hypes(2))
    with pytest.raises(ValueError, match="inconsistent sizes"):
        jax.eval_shape(model.apply, scope_variables,
                       jax.tree.map(jnp.asarray, scene))
    port = build_model(hypes(2), device="cpu")
    load_flax_variables(port, scope_variables)
    with pytest.raises(ValueError, match="pairwise_over_frames"):
        port(batch_to_torch(scene, "cpu"))


def test_scope_forward_on_the_loaded_batch_matches_jax(scope_batch, scope_variables):
    scene = {k: v for k, v in scope_batch[1].items() if k != "labels"}
    want = jax.jit(lambda v, b: jax_build_model(hypes(2)).apply(v, b))(
        scope_variables, jax.tree.map(jnp.asarray, scene))
    port = build_model(hypes(2), device="cpu")
    load_flax_variables(port, scope_variables)
    with torch.no_grad():
        got = port(batch_to_torch(scene, "cpu"))
    for k in ("psm", "rm", "psm_single_v", "rm_single_i"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * (1 + np.abs(w).max()), err_msg=k)


@pytest.fixture(scope="module")
def scope_step(scope_batch, scope_variables):
    """One train step of the tiny SCOPE config on the loaded batch: JAX's
    float64 step and the port's f32 step from the same variables."""
    h = hypes(2)
    batch = scope_batch[1]
    params, stats, jparts, grads = jax_step(h, batch, scope_variables,
                                            dtype=jnp.float64)
    model, parts = port_step(h, batch, scope_variables)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(h, grads, stats), after=twin(h, params, stats))


def test_scope_train_step_loss_parts_match_jax(scope_step):
    check_loss_parts(scope_step["parts"], scope_step["jparts"])


def test_scope_train_step_gradients_match_jax(scope_step):
    check_gradients(scope_step["model"], scope_step["grads"])


def test_scope_train_step_params_and_bn_stats_match_jax(scope_step):
    assert check_params_and_stats(scope_step["model"], scope_step["after"],
                                  scope_step["grads"], min_clear=100) > 100
