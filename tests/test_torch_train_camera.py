"""Camera training: the port's train step of every camera composition an
AirV2X camera config names (Where2comm with its keep fraction, V2X-ViT,
CoBEVT, When2com) and of ``lift_splat_shoot_airv2x`` against one JAX
``make_train_step`` update on the CPU in f32, from one bridged
initialisation (LSS's camera encoder in float64:
tests/test_torch_train_camera_fusions.py); the running statistics of each camera
trunk and of the BEV encoder after a train-mode forward against flax (at
their JAX momenta: 0.99 in EfficientNet, 0.9 in the torchvision parts);
``point_pillar_depth_loss``; the train CLI on a camera config, on
synthetic scenes and on the on-disk fixture.

The compositions give the vehicles LiDAR and cameras (``lidar+cam``: the
mean of the two BEV maps, gt-depth lifting, one EfficientNet per model,
which keeps the JAX traces short); LSS reads the vehicles' cameras alone,
depth from its softmax head. The batch is ``torch_train_helpers.
labelled_batch`` with camera stacks per sample (``add_camera_batch``, seed
CAMERA_SEED, the first from 0 up whose frustum points of the present agents
lie more than CELL_MARGIN of a cell from a boundary, where the two
packages' geometry could round a point into neighbouring cells).
Tolerances are the flagship's (tests/test_torch_train.py), as stated in
tests/test_torch_train_models.py; modules f32 1e-4 x (1 + scale) on
outputs, 1e-5 on statistics.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models.camera import lss as jlss
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data import camera as tcam
from airv2x_tpu_torch.data.synthetic import add_camera_batch, batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.camera import lss
from airv2x_tpu_torch.tools import train as train_cli
from airv2x_tpu_torch.utils.checkpoint import find_last_epoch
from tests.fixture_utils import cam_hypes, make_fixture
from tests.test_torch_train import _comm_cut_gaps
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread
from tests.torch_train_helpers import (
    XLA_OPT0, check_gradients, check_loss_parts, check_params_and_stats,
    labelled_batch, run_both, variables_for)

CAMERA_SEED = 0
CELL_MARGIN = 1e-4  # cell widths
LSS = "lift_splat_shoot_airv2x"
# (model name, camera kind); CoBEVT and When2com are in
# tests/test_torch_train_camera_fusions.py
CASES = (("airv2x_where2comm", "lidar+cam"), ("airv2x_v2xvit", "lidar+cam"),
         (LSS, "cam"))
# f32 tolerances of a camera step. The camera trunks' train-mode BNs take
# their statistics over few values per channel (48 at EfficientNet's last
# stage here), and their backward amplifies each package's f32 rounding:
# the two packages' train-mode outputs differ by up to 2.3e-4 of their
# scale where the eval outputs agree to 3e-6, the trunk gradients by up to
# 4.2% of a leaf's scale. In float64 the trunks agree to 1e-13
# (test_camera_module_gradients_match_jax_f64), so the f32 bounds below are
# the rounding's, set at about twice the largest measured.
CAMERA_LOSS_TOL = 2e-4  # relative
CAMERA_GRAD_TOL = 0.1  # of a leaf's scale, plus STEP_GRAD_FLOOR of the largest
CAMERA_STAT_TOL = 1e-3  # x (1 + |statistic|)
# When2com's handshake (a softmax of key . query over the agents, the
# policy CNN's train-mode BNs over 8 maps) amplifies it further: the port's
# gradients lie up to 21% of a leaf's scale from the JAX step's (jitted at
# XLA_OPT0, tests/test_torch_train_eager.py; the last deblock), so its bound
# is
WHEN2COM_GRAD_TOL = 0.3
# Where2comm's keep cut lies on a relative confidence gap of at least this
# (the packages' train-mode outputs differ by up to ~2.7e-5 of their scale);
# on this batch the first such cut below the top tenth keeps 89%
CAMERA_CUT_GAP = 2e-4


def camera_hypes(load, name, kind):
    return CHIP_SMOKE.tiny_composition_hypes(load(TINY), name, "det", kind)


@pytest.fixture(scope="module")
def batch():
    hypes = camera_hypes(load_yaml, LSS, "cam")
    return add_camera_batch(
        labelled_batch(), hypes, SlotLayout.from_args(hypes["model"]["args"]),
        np.random.default_rng(CAMERA_SEED), ncam=CHIP_SMOKE.TINY_CAMERA_NCAM)


def test_camera_batch_clears_the_cell_margin(batch):
    for kind in ("cam", "lidar+cam"):
        hypes = camera_hypes(load_yaml, "airv2x_where2comm", kind)
        assert CHIP_SMOKE.camera_frustum_margin(hypes, batch) > CELL_MARGIN
    assert not batch["agent_mask"].all()


def _keep_fraction(th, variables, batch, target=0.85):
    """A keep fraction near ``target`` whose cut lies on a relative
    confidence gap of at least CAMERA_CUT_GAP in every present agent."""
    gaps = _comm_cut_gaps(th, variables, batch).min(0)
    hw = gaps.shape[0] + 1
    ks = np.nonzero(gaps > CAMERA_CUT_GAP)[0] + 1
    k = ks[np.argmin(np.abs(ks - target * hw))]
    assert 0.1 < k / hw < 0.95
    return np.float32((k + 0.5) / hw)


def camera_step_run(batch, name, kind):
    """run_both for a camera composition, with its gradient tolerance."""
    jh = camera_hypes(jax_load_yaml, name, kind)
    th = camera_hypes(load_yaml, name, kind)
    variables = variables_for(jh, batch)
    u = _keep_fraction(th, variables, batch) if name == "airv2x_where2comm" else None
    opts = XLA_OPT0 if name == "airv2x_when2com" else None
    run = run_both(jh, th, batch, variables, u=u, compiler_options=opts)
    run["grad_tol"] = (WHEN2COM_GRAD_TOL if name == "airv2x_when2com"
                       else CAMERA_GRAD_TOL)
    return run


@pytest.fixture(scope="module", params=CASES, ids=[n for n, _ in CASES])
def step_run(request, batch):
    return camera_step_run(batch, *request.param)


def test_camera_train_step_loss_parts_match_jax(step_run):
    print("loss parts, largest relative error",
          check_loss_parts(step_run["parts"], step_run["jparts"], CAMERA_LOSS_TOL))


def test_camera_train_step_gradients_match_jax(step_run):
    print("gradients, largest share of the bound",
          check_gradients(step_run["model"], step_run["grads"],
                          step_run["grad_tol"]))


def test_camera_train_step_params_and_bn_stats_match_jax(step_run):
    n = check_params_and_stats(step_run["model"], step_run["after"],
                               step_run["grads"], grad_tol=step_run["grad_tol"],
                               stat_tol=CAMERA_STAT_TOL)
    assert n > 100  # the camera encoder's running statistics among them


def test_gt_depth_onehot_clamps_in_train_mode():
    """In eval mode an out-of-range depth has no bin (an all-zero row); in
    train mode it is clamped into the end bins, as the JAX package passes
    ``target=train``."""
    cfg = dict(CHIP_SMOKE.TINY_CAM)
    enc = lss.LSSCameraEncoder(cfg)
    depth = torch.full((1, 64, 96), 30.0)
    depth[0, 4, 4] = 0.5  # below the first bin
    depth[0, 12, 12] = 80.0  # beyond the last bin (clamped to d_max first)
    for train in (False, True):
        onehot = enc.train(train).gt_depth_onehot(depth)
        jidx, jvalid = jlss.bin_depth_indices(
            jnp.minimum(jnp.asarray(depth.numpy()), 50.0), "LID", 2, 50, 8,
            target=train)
        want = (jax.nn.one_hot(jidx, 8) * jvalid[..., None])[:, 4::8, 4::8]
        np.testing.assert_array_equal(onehot.numpy(), np.asarray(want))
        assert bool((onehot.sum(-1) == 1).all()) == train


# --- point_pillar_depth_loss -------------------------------------------------------

@pytest.mark.parametrize("with_depth", [False, True], ids=["no-depth", "depth"])
def test_depth_loss_matches_jax(batch, with_depth):
    """The multiclass loss plus, with ``depth_logits`` in the output and
    ``depth_labels`` in the target, the f32 mean depth-bin NLL weighted by
    ``depth_weight`` (0.5 here): the loss parts (1e-5 relative) and the
    gradients of every output (1e-4 of the largest) against JAX's
    ``point_pillar_depth_loss``."""
    jh, th = (load(TINY) for load in (jax_load_yaml, load_yaml))
    for h in (jh, th):
        h["loss"]["det"]["core_method"] = "point_pillar_depth_loss"
        h["loss"]["det"]["args"]["depth_weight"] = 0.5
    rng = np.random.default_rng(60)
    out = {"psm": rng.normal(0, 3, (2, 48, 48, 14)),
           "rm": rng.normal(0, 1, (2, 48, 48, 14)),
           "obj": rng.normal(0, 3, (2, 48, 48, 2))}
    labels = dict(batch["labels"])
    if with_depth:
        out["depth_logits"] = rng.normal(0, 2, (2, 8, 12, 8))
        labels["depth_labels"] = rng.integers(0, 8, (2, 8, 12)).astype(np.int32)
    out = {k: v.astype(np.float32) for k, v in out.items()}
    jloss = jax_build_loss(jh)

    def jfn(o):
        return jloss({**o, "comm_rate": jnp.asarray(0.5)},
                     jax.tree.map(jnp.asarray, labels))

    (_, jparts), jgrad = jax.value_and_grad(jfn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    touts = {k: torch.from_numpy(v).requires_grad_(True) for k, v in out.items()}
    total, parts = build_loss(th)(dict(touts, comm_rate=torch.tensor(0.5)),
                                  batch_to_torch(labels, "cpu"))
    total.backward()
    assert set(parts) == set(jparts)
    assert ("depth_loss" in parts) == with_depth
    for k in parts:
        assert float(parts[k]) == pytest.approx(float(jparts[k]), rel=1e-5,
                                                abs=1e-6), k
    for k, t in touts.items():
        want = np.asarray(jgrad[k])
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= 1e-4 * np.abs(want).max(), (k, err)


# --- the CLI -----------------------------------------------------------------------

def _write_config(path, hypes):
    with open(path, "w") as f:
        yaml.safe_dump(jax.tree.map(lambda v: v.tolist() if hasattr(v, "tolist")
                                    else v, hypes), f)
    return str(path)


def _read_losses(run_dir):
    with open(os.path.join(run_dir, "train_loss.txt")) as f:
        line = f.read()
    assert line.startswith("epoch 1/1") and "total_loss" in line
    assert "nan" not in line and "inf" not in line
    return line


def test_cli_trains_a_camera_config_on_synthetic_scenes(tmp_path):
    """One epoch of the tiny LiDAR + camera Where2comm config: the synthetic
    batches carry the per-type camera stacks, drawn after each scene."""
    hypes = camera_hypes(load_yaml, "airv2x_where2comm", "lidar+cam")
    layout = SlotLayout.from_args(hypes["model"]["args"])
    b = next(train_cli.synthetic_batches(hypes, layout, 2, 1, 0, device="cpu"))
    assert b["cam_vehicle"]["imgs"].shape == (2, 4, 2, 64, 96, 4)
    assert set(k for k in b if k.startswith("cam_")) == {
        "cam_vehicle", "cam_rsu", "cam_drone"}
    cfg = _write_config(tmp_path / "cfg.yaml", hypes)
    run_dir = train_cli.main(["--hypes_yaml", cfg, "--device", "cpu",
                              "--log_dir", str(tmp_path / "logs"),
                              "--steps_per_epoch", "2", "--epochs", "1"])
    assert find_last_epoch(run_dir) == 1
    _read_losses(run_dir)


def test_cli_trains_a_camera_config_on_disk(tmp_path, monkeypatch):
    """The tiny config with the vehicles' cameras on the camera fixture:
    ``AirV2XDataset`` / ``RealDataLoader`` in train mode, with the train
    branch of the camera augmentation (the fixture's aug keys supplied, as a
    run on the shipped camera YAMLs supplies them)."""
    root = make_fixture(str(tmp_path / "data"), n_timestamps=2, with_camera=True)
    hypes = cam_hypes(load_yaml(TINY), ("vehicle",))
    hypes["root_dir"] = hypes["validate_dir"] = root
    seen = []
    real = tcam.sample_augmentation

    def spy(conf, train, rng=None):
        seen.append(train)
        return real(conf, train, rng)

    monkeypatch.setattr(tcam, "sample_augmentation", spy)
    cfg = _write_config(tmp_path / "cfg.yaml", hypes)
    run_dir = train_cli.main(["--hypes_yaml", cfg, "--device", "cpu",
                              "--log_dir", str(tmp_path / "logs"), "--epochs",
                              "1", "--num_workers", "1"])
    assert find_last_epoch(run_dir) == 1
    _read_losses(run_dir)
    assert True in seen and False in seen  # train batches, then validation


# on synthetic scenes the CLI refuses a radar-only model the JAX CLI draws
# no radar cloud for (SpatialCooper with ``use_modality: processed_radar``)
# and BM2CP (ROADMAP §3)
REFUSED = {"point_pillar_lrf": "point_pillar_spatialcooper",
           "airv2x_bm2cp": "airv2x_bm2cp"}


@pytest.mark.parametrize("core", ["point_pillar_lrf", "airv2x_bm2cp"])
def test_cli_refuses_radar_and_bm2cp(tmp_path, core):
    hypes = load_yaml(TINY)
    hypes["model"]["core_method"] = REFUSED[core]
    if core == "point_pillar_lrf":
        hypes["model"]["args"]["use_modality"] = "processed_radar"
    cfg = _write_config(tmp_path / "cfg.yaml", hypes)
    with pytest.raises(NotImplementedError,
                       match="processed_radar" if core == "point_pillar_lrf"
                       else "BM2CP"):
        train_cli.main(["--hypes_yaml", cfg, "--device", "cpu",
                        "--log_dir", str(tmp_path / "logs")])
    assert not (tmp_path / "logs").exists()  # refused before any run dir
