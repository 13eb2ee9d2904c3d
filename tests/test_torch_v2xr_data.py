"""The V2X-R data path of the port against the JAX package on the CPU:

  * the synthetic radar cloud of ``make_scene`` / ``make_batch``
    (``radar_points_per_agent``): bit-identical to JAX's, and a seeded
    scene's other arrays unchanged by it; the train CLI's synthetic batches
    and the inference CLI's synthetic scenes carry it for the models that
    read radar (``needs_radar``) and only for those;
  * ``OPV2VDataset(use_radar=True)`` on tests/test_torch_opv2v_data.py's
    split with a ``<timestamp>_radar.pcd`` per cav (one cav without):
    single, temporal (the current frame's radar) and without ``proj_first``,
    sample for sample against JAX's, the radar keys included; the ego mask
    is not applied to radar; ``RealDataLoader`` batches carry the keys;
  * the train CLI's refusals: a radar-only AdaFusion config on synthetic
    scenes says why; RTNH, MDD and the LiDAR + radar models pass;
  * the train CLI's synthetic batches of RTNH (no radar: it encodes the
    LiDAR cloud, ROADMAP §3) and MDD (a radar cloud) equal JAX's.
"""

import os

import numpy as np
import pytest
import yaml

from airv2x_tpu.data.opv2v_dataset import OPV2VDataset as JaxOPV2V
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.tools import train as jax_train
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data import opv2v_dataset as port_opv2v
from airv2x_tpu_torch.data.loader import RealDataLoader
from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
from airv2x_tpu_torch.data.pcd import write_pcd
from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.tools import inference, train
from tests.test_torch_data import (
    CLOUD_TOL, CROP_MARGIN, assert_same_sample, record_crop_margins)
from tests.test_torch_opv2v_data import hypes, root  # noqa: F401
from tests.torch_port_helpers import REPO
from tests.test_torch_v2xr_models import v2xr_hypes

RADAR_KEYS = ("radar_points", "radar_points_mask")
NO_RADAR = ("900", "000070")  # (cav, stamp) written without a radar cloud


@pytest.fixture(scope="module")
def radar_root(root):  # noqa: F811
    """The OPV2V split with a radar cloud per cav and stamp: 120 points,
    sparser than the LiDAR's 400 and noisier, four of them within 2 m of
    the sensor (the LiDAR's ego mask does not apply to radar)."""
    scen = os.path.join(root, "2021_08_16_01_01_01")
    rng = np.random.default_rng(5)
    for cav in sorted(os.listdir(scen)):
        for t in ("000068", "000070"):
            if (cav, t) == NO_RADAR:
                continue
            pts = rng.normal(scale=18.0, size=(120, 4)).astype(np.float32)
            pts[:, 2] = rng.uniform(-1.5, 0.5, 120) - 1.9
            pts[:4, :2] = rng.uniform(-1.5, 1.5, (4, 2))
            pts[:, 3] = rng.uniform(0, 1, 120)
            write_pcd(os.path.join(scen, cav, f"{t}_radar.pcd"), pts)
    return root


def _split_radar(sample):
    batch, gt = sample
    return ({k: v for k, v in batch.items() if k not in RADAR_KEYS}, gt,
            {k: batch[k] for k in RADAR_KEYS})


SAMPLES = {"single": dict(), "temporal": dict(frames=2),
           "no-proj-first": dict(proj_first=False)}


@pytest.mark.parametrize("kind", sorted(SAMPLES))
def test_radar_dataset_matches_jax(radar_root, monkeypatch, kind):
    """Every sample with ``use_radar``: the LiDAR part as the LiDAR tests
    hold it, the radar clouds within CLOUD_TOL where valid (the JAX package
    reads PCD files through its native reader, the port through numpy;
    every transformed radar point lies more than CROP_MARGIN from the range
    crop), their masks and padding equal."""
    margins = record_crop_margins(monkeypatch, port_opv2v)
    h = hypes(**SAMPLES[kind])
    jds = JaxOPV2V(h, radar_root, train=False, use_radar=True)
    tds = OPV2VDataset(h, radar_root, train=False, use_radar=True)
    assert len(tds) == len(jds) == 2
    n_radar = 0
    for i in range(len(tds)):
        jb, jg, jr = _split_radar(jds[i])
        tb, tg, tr = _split_radar(tds[i])
        assert_same_sample((jb, jg), (tb, tg), f"{kind} sample {i}")
        m = jr["radar_points_mask"]
        np.testing.assert_array_equal(tr["radar_points_mask"], m)
        assert tr["radar_points"].shape == jr["radar_points"].shape == (
            4, 2048 // 4, 4)
        assert tr["radar_points"].dtype == np.float32
        np.testing.assert_allclose(tr["radar_points"][m], jr["radar_points"][m],
                                   rtol=CLOUD_TOL, atol=CLOUD_TOL)
        np.testing.assert_array_equal(tr["radar_points"][~m], 0.0)
        counts = m.sum(-1)
        agents = tb["agent_mask"][-1] if tb["agent_mask"].ndim == 2 else \
            tb["agent_mask"]
        assert (counts[~agents] == 0).all() and (counts[agents] > 0).all()
        n_radar += int(counts.sum())
        if kind != "no-proj-first":  # the 2 m ego box keeps its radar points
            near = (np.abs(tr["radar_points"][0, :, :2]) < 2.0).all(-1) & m[0]
            assert near.sum() >= 1
    assert n_radar > 0
    if kind != "no-proj-first":
        assert min(margins) > CROP_MARGIN


def test_radar_batches_through_the_loader(radar_root):
    """``RealDataLoader`` stacks the radar keys like the others; the
    dataset without ``use_radar`` gives none."""
    h = hypes()
    loader = RealDataLoader(OPV2VDataset(h, radar_root, train=False,
                                         use_radar=True), h, 2, train=False,
                            device="cpu")
    (batch, _), = list(loader.batches(0, with_gt=True))
    assert tuple(batch["radar_points"].shape) == (2, 4, 512, 4)
    assert tuple(batch["radar_points_mask"].shape) == (2, 4, 512)
    assert int(batch["radar_points_mask"].sum()) > 0
    plain = OPV2VDataset(h, radar_root, train=False)[0][0]
    assert not set(RADAR_KEYS) & set(plain)


# --- synthetic radar --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_radar_matches_jax(seed):
    """``make_scene`` with a radar cloud equals JAX's bit for bit, and its
    other arrays equal a scene drawn without radar from the same seed."""
    kw = dict(num_objects=6, points_per_agent=1024,
              lidar_range=(-51.2, -51.2, -3, 51.2, 51.2, 1), pts_per_box=60)
    layout = SlotLayout(counts=(2, 1, 1))
    jb, jg = jax_make_scene(np.random.default_rng(seed), JaxSlotLayout(
        counts=(2, 1, 1)), radar_points_per_agent=128, **kw)
    tb, tg = make_scene(np.random.default_rng(seed), layout,
                        radar_points_per_agent=128, **kw)
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    plain, pg = make_scene(np.random.default_rng(seed), layout, **kw)
    assert not set(RADAR_KEYS) & set(plain)
    for k in plain:
        np.testing.assert_array_equal(plain[k], tb[k], err_msg=k)
    for k in pg:
        np.testing.assert_array_equal(pg[k], tg[k], err_msg=k)
    live = tb["agent_mask"]
    counts = tb["radar_points_mask"].sum(-1)
    np.testing.assert_array_equal(
        counts[live], np.minimum(128, tb["points_mask"].sum(-1)[live] // 8))
    assert (counts[~live] == 0).all()


def test_cli_synthetic_scenes_carry_radar_where_the_model_reads_it():
    """The train CLI's synthetic batches equal JAX's, radar included, for a
    LiDAR + radar model (``max_points // 8`` radar points per agent), and
    carry no radar for a LiDAR model; the inference CLI's synthetic scenes
    likewise."""
    layout = SlotLayout(counts=(3, 0, 0))
    for name, radar in (("point_pillar_intermediate_lrf", True),
                        ("point_pillar_spatialcooper", False),
                        ("rtnh_intermediate", False),
                        ("point_pillar_intermediate_lrf_MDD", True)):
        h = v2xr_hypes("point_pillar_intermediate_lrf")
        h["model"]["core_method"] = name
        h["preprocess"]["max_points"] = 512
        assert train.needs_radar(h) == radar
        want = next(jax_train.synthetic_batches(h, JaxSlotLayout(counts=(3, 0, 0)),
                                                2, 1, 9))
        got = next(train.synthetic_batches(h, layout, 2, 1, 9, device="cpu"))
        assert set(got) == set(want)
        for k in RADAR_KEYS if radar else ():
            assert got[k].shape[2] == 512 // 8
            np.testing.assert_array_equal(got[k], want[k])
        _, scenes = inference.scenes(h, layout, "", 1, 9)
        _, batch, _ = next(scenes)
        assert (set(RADAR_KEYS) <= set(batch)) == radar


# --- the train CLI's refusals -----------------------------------------------


def _yaml(path):
    return load_yaml(os.path.join(REPO, "hypes_yaml", "V2X-R", path))


@pytest.mark.parametrize("path", ["4DRadar/V2XR_RTNH.yaml",
                                  "L_4DR_Fusion_with_MDD/V2XR_AttFuse.yaml"])
def test_refuse_unported_names_item_7(path):
    """RTNH and MDD pass the CLI's refusal on synthetic scenes: RTNH
    encodes the LiDAR cloud there, MDD the radar cloud the CLI draws for it
    (ROADMAP §3)."""
    h = _yaml(path)
    train.refuse_on_synthetic(h)
    assert train.needs_radar(h) == ("MDD" in path)


def test_refuse_radar_only_adafusion_on_synthetic_scenes():
    """``4DRadar/V2XR_adafusion.yaml`` encodes the radar cloud, which the
    synthetic scenes give only the l4dr / lrf / interf / mdd models (the JAX
    CLI's ``needs_radar``): refused there with the reason, served on a
    dataset; the LiDAR + radar configs pass."""
    ada = _yaml("4DRadar/V2XR_adafusion.yaml")
    with pytest.raises(NotImplementedError, match="processed_radar"):
        train.refuse_on_synthetic(ada)
    for path in ("LiDAR/V2XR_adafusion.yaml", "L_4DR_Fusion/V2XR_L4DR.yaml",
                 "L_4DR_Fusion/V2XR_AdaFusion.yaml",
                 "L_4DR_Fusion/V2XR_InterFusion.yaml",
                 "4DRadar/V2XR_PFA_net.yaml"):
        train.refuse_on_synthetic(_yaml(path))
