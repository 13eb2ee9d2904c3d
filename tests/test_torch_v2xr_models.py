"""The V2X-R models of the port against the JAX package on the CPU:

  * the new modules through the weight bridge: ``InterRAL`` with padded
    pillar rows (eval, and train mode with its masked BN statistics), the
    three-stream ``MGFBackbone``, SpatialCooper's Conv3d fusion over
    (feature channel, H, W), and the flat SiCP's dual heads in train mode;
  * every new registry name end to end at tiny size (the flat family's
    tiny config, tests/test_torch_point_pillar_family.py, plus a radar cloud
    of an eighth of each agent's points), f32, in both conv modes: psm / rm
    within 1e-4 x (1 + scale), comm_rate, and the keep sets of the decode;
    ``point_pillar_scope_lrf`` on the tiny temporal SCOPE scene with a
    radar cloud per frame;
  * one train step each of L4DR and ``point_pillar_intermediate_lrf``
    against JAX's float64 ``make_train_step``.
"""

import copy
import subprocess
import sys

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airv2x_tpu.models.radar_models as jradar
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.models.fusion.common import ego_agent_attention as jax_ego_att
from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.common import ego_agent_attention
from airv2x_tpu_torch.models.radar_models import InterRAL, MGFBackbone
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_point_pillar_family import EXTRAS
from airv2x_tpu_torch.data.postprocess import decode_detections
from tests.test_torch_coalign import TOP_K, keep_sets
from tests.test_torch_point_pillar_family import RANGE, TOL, V2XVIT, tiny_hypes
from tests.torch_port_helpers import (
    CHIP_SMOKE, REPO, assert_close, nchw_to_nhwc, nhwc_to_nchw,
    one_torch_thread, random_variables)  # noqa: F401
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    port_step, twin)

NMS_MARGIN = 1e-4
RADAR_PER_AGENT = 64  # the radar buffer: the tiny clouds' 512 slots // 8
SICP = {"in_channels": 64, "out_channels": 32, "voxel_size": [0.4, 0.4, 4],
        "downsample_rate": 2}
RADAR = {"use_modality": "processed_radar"}
# registry name -> the model args added to the tiny flat config
CASES = {
    "point_pillar_sicp": SICP,
    "point_pillar_spatialcooper": {},
    "point_pillar_adafusion": RADAR,
    "PFA_net": {},
    "pfanet": RADAR,
    "pfa_net": {},
    "point_pillar_attresnet": {},
    "point_pillar_intermediate_lrf": {},
    "point_pillar_v2xvit_lrf": {"transformer": V2XVIT},
    "point_pillar_cobevt_lrf": EXTRAS["point_pillar_cobevt"],
    "point_pillar_where2comm_lrf": EXTRAS["point_pillar_where2comm"],
    "point_pillar_coalign_lrf": {},
    "point_pillar_spatialcooper_lrf": {},
    "point_pillar_sicp_lrf": SICP,
    "point_pillar_l4dr": {},
    "point_pillar_L4DR": {},
    "point_pillar_interf": {"interral_channels": 32},
    "point_pillar_InterF": {"interral_channels": 32},
}
TEMPORAL = "point_pillar_scope_lrf"
TRAIN = ("point_pillar_l4dr", "point_pillar_intermediate_lrf")
# the variables seed (default 5) of a case whose seed-5 decode decides an
# NMS suppression within NMS_MARGIN of the threshold (L4DR 1.1e-5, the
# intermediate twin 5.1e-5) or keeps nothing (the SiCP twin): the first
# from 5 up with a margin above 1e-3 that keeps boxes
SEEDS = {"point_pillar_l4dr": 6, "point_pillar_L4DR": 6,
         "point_pillar_intermediate_lrf": 6, "point_pillar_sicp_lrf": 7}


def nms_decision_margin(hypes, out):
    """The smallest distance from the NMS threshold of any NMS decision of
    the port's decode, per sample (``chip_smoke.py:nms_decision_margin``:
    each candidate's largest IoU with a kept candidate ranked above it
    decides whether it is suppressed, so IoUs that move by less than this
    margin leave every keep set as it is)."""
    anchors = torch.from_numpy(generate_anchor_grid(
        hypes["postprocess"]["anchor_args"]))
    lr = torch.tensor(hypes["preprocess"]["cav_lidar_range"])
    thr = hypes["postprocess"]["nms_thresh"]
    margin = 1.0
    for b in range(out["psm"].shape[0]):
        psm = out["psm"][b]
        det = decode_detections(psm, out["rm"][b], psm, anchors, torch.eye(4), lr,
                                num_class=1, obj_threshold=0.2, nms_thresh=thr,
                                top_k=TOP_K)
        margin = min(margin, CHIP_SMOKE.nms_decision_margin(det, hypes, TOP_K))
    return margin


def v2xr_hypes(name):
    h = tiny_hypes("point_pillar")
    h["model"]["core_method"] = name
    h["model"]["args"].update(copy.deepcopy(CASES[name]))
    h["postprocess"]["target_args"]["obj_threshold"] = 0.2
    return h


# every module of the port imported first, in one interpreter that drops the
# port's modules between imports
FIRST_IMPORTS = """
import glob, importlib, os, sys
root, failed = sys.argv[1], []
pkg = os.path.join(root, "airv2x_tpu_torch")
for path in sorted(glob.glob(os.path.join(pkg, "**", "*.py"), recursive=True)):
    mod = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
    for m in [m for m in sys.modules if m.startswith("airv2x_tpu_torch")]:
        del sys.modules[m]
    try:
        importlib.import_module(mod.removesuffix(".__init__"))
    except ImportError as e:
        failed.append(f"{mod}: {e}")
print("\\n".join(failed))
sys.exit(1 if failed else 0)
"""


def test_every_port_module_imports_first():
    """Each module of the port imports when no other module of the port is
    loaded: importing ``ops/fast_pillars.py`` first was a circular import
    (it imports ``models/nn.py``, whose package loaded the registry, whose
    models import ``ops/fast_pillars.py``)."""
    r = subprocess.run([sys.executable, "-c", FIRST_IMPORTS, REPO], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr


def test_registry_has_the_v2xr_names():
    names = set(CASES) | {TEMPORAL}
    assert names <= set(MODEL_REGISTRY) and len(names) == 19
    assert len(MODEL_REGISTRY) == 56  # and RTNH's and MDD's two names each


@pytest.fixture(scope="module")
def batch():
    """Two labelled tiny scenes with radar clouds (JAX ``make_batch`` seed
    3), the second's third slot absent, poses perturbed (seed 2)."""
    h = v2xr_hypes("point_pillar_l4dr")
    anchors = generate_anchor_grid(h["postprocess"]["anchor_args"])
    b, _ = jax_make_batch(
        np.random.default_rng(3), JaxSlotLayout(counts=(3, 0, 0)), 2,
        anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=h["postprocess"]["target_args"], num_objects=4,
        points_per_agent=512, lidar_range=RANGE, max_boxes=20, pts_per_box=40,
        radar_points_per_agent=RADAR_PER_AGENT)
    for k in ("agent_mask", "points_mask", "radar_points_mask"):
        b[k][1, 2] = False
    # an eighth of each live agent's points, noisier
    np.testing.assert_array_equal(b["radar_points_mask"].sum(-1),
                                  b["points_mask"].sum(-1) // 8)
    return perturb_poses(b, np.random.default_rng(2))


def _scene(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module")
def runs(batch):
    """name -> (hypes, flax variables, JAX eval outputs), computed once per
    model class, model args and seed (the aliases share one)."""
    cache = {}

    def get(name):
        h = v2xr_hypes(name)
        model = jax_build_model(h)
        key = (type(model).__name__, repr(CASES[name]), SEEDS.get(name, 5))
        if key not in cache:
            scene = jax.tree.map(jnp.asarray, _scene(batch))
            var = random_variables(model, scene, seed=key[2], train=False)
            out = jax.jit(lambda v, b: model.apply(v, b, train=False))(var, scene)
            cache[key] = (var, jax.tree.map(np.asarray, out))
        return (h,) + cache[key]

    return get


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(batch, runs, name, mode, monkeypatch):
    """psm / rm / comm_rate of the port's f32 model (``pallas``: the conv
    kernel's plain version) against JAX's from the same flax variables;
    in ``auto`` also the keep sets of the decode."""
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    h, var, want = runs(name)
    model = build_model(h, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    for k in ("psm", "rm"):
        assert got[k].shape == want[k].shape
        assert_close(got[k].numpy(), want[k], atol=TOL * (1 + np.abs(want[k]).max()),
                     rtol=0, what=k)
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                     rel=1e-6)
    if mode == "auto":
        assert nms_decision_margin(h, got) > NMS_MARGIN
        pairs, _ = keep_sets(h, want, got)
        for jkeep, tkeep in pairs:
            np.testing.assert_array_equal(tkeep, jkeep)
        assert sum(int(j.sum()) for j, _ in pairs) > 0


def test_radar_modality_moves_the_outputs(runs):
    """AdaFusion and PFA-Net with ``use_modality: processed_radar`` encode
    the radar cloud: on the same weights as their LiDAR twins (one seed,
    one variables tree) their JAX outputs differ, and the forward test holds
    the port to each."""
    for radar, lidar in (("pfanet", "PFA_net"),
                         ("point_pillar_adafusion", "point_pillar_spatialcooper")):
        _, var_r, want_r = runs(radar)
        _, var_l, want_l = runs(lidar)
        jax.tree.map(np.testing.assert_array_equal, var_r, var_l)
        assert np.abs(want_r["psm"] - want_l["psm"]).max() > 1e-3


def test_scope_lrf_matches_jax():
    """``point_pillar_scope_lrf`` on the tiny SCOPE config (ResNet, 2 frames,
    perturbed history and poses) with a radar cloud per frame and agent:
    each frame's batch takes ``radar_points[:, i]``; psm / rm and the keep
    set."""
    hypes = CHIP_SMOKE.tiny_scope_hypes(resnet=True)
    hypes["model"]["core_method"] = TEMPORAL
    layout = JaxSlotLayout(counts=(3, 0, 0))
    b = CHIP_SMOKE.scope_scene(np.random.default_rng(0), layout, 2,
                               CHIP_SMOKE.TINY_SCOPE_RANGE,
                               pose_rng=np.random.default_rng(1),
                               points_per_agent=512)
    rng = np.random.default_rng(7)
    b["radar_points"] = b["points"][..., ::8, :] + np.concatenate(
        [rng.normal(0, 0.15, b["points"][..., ::8, :3].shape),
         np.zeros(b["points"][..., ::8, 3:].shape)], -1).astype(np.float32)
    b["radar_points_mask"] = b["points_mask"][..., ::8].copy()
    b["agent_mask"][:, :, 2] = False
    for k in ("points_mask", "radar_points_mask"):
        b[k][:, :, 2] = False
    jm = jax_build_model(hypes)
    scene = jax.tree.map(jnp.asarray, b)
    var = random_variables(jm, scene, seed=4, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, x: jm.apply(v, x, train=False))(var, scene))
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    assert model.radar_vfe is not None
    with torch.no_grad():
        got = model(batch_to_torch(b, "cpu"))
    for k in ("psm", "rm"):
        assert_close(got[k].numpy(), want[k],
                     atol=TOL * (1 + np.abs(want[k]).max()), rtol=0, what=k)
    assert nms_decision_margin(hypes, got) > NMS_MARGIN
    (jkeep, tkeep), = keep_sets(hypes, want, got)[0]
    np.testing.assert_array_equal(tkeep, jkeep)
    assert jkeep.sum() > 0


# --- the modules ----------------------------------------------------------


def _rows(rng, n, k, live):
    x = rng.normal(0, 1, (1, n, k, 10)).astype(np.float32)
    m = np.zeros((1, n), bool)
    m[0, :live] = True
    x[0, ~m[0]] = 0.0
    return x, m


@pytest.mark.parametrize("train", [False, True])
def test_interral_matches_jax(train):
    """Both directions of InterRAL on pillar lists with padded rows (x 12
    rows of which 9 real, y 7 of which 5, 4 point slots), eval and train
    mode: the outputs of the real rows, and the updated BN statistics."""
    rng = np.random.default_rng(0)
    x, xm = _rows(rng, 12, 4, 9)
    y, ym = _rows(rng, 7, 4, 5)
    jm = jradar.InterRAL(channels=32)
    var = random_variables(jm, x, y, xm, ym, seed=1)
    port = InterRAL(10, 32)
    load_flax_variables(port, var)
    port.train(train)
    for args in ((x, y, xm, ym), (y, x, ym, xm)):
        want = jm.apply(var, *map(jnp.asarray, args), train,
                        mutable=["batch_stats"] if train else False)
        want, stats = (want if train else (want, None))
        got = port(*map(torch.from_numpy, args))
        real = args[2][0]
        want = np.asarray(want)[0, real]
        assert_close(got.detach().numpy()[0, real], want,
                     atol=TOL * (1 + np.abs(want).max()), rtol=0)
        if train:
            bn = stats["batch_stats"]["MaskedBatchNorm_0"]
            assert_close(port.bn.running_mean.numpy(), np.asarray(bn["mean"]),
                         atol=1e-5, rtol=0)
            assert_close(port.bn.running_var.numpy(), np.asarray(bn["var"]),
                         atol=1e-5, rtol=0)
            load_flax_variables(port, var)  # the next direction's start


class _JaxMGF(flax.linen.Module):
    """The JAX MGFBackbone with per-level ego attention as its fusion."""

    cfg: dict

    @flax.linen.compact
    def __call__(self, x, lx, rx, am):
        def fuse(f):
            return jax_ego_att(f.reshape(am.shape + f.shape[1:]), am)

        return jradar.MGFBackbone(**self.cfg, name="mgf")(x, lx, rx, fuse, False)


def test_mgf_backbone_matches_jax():
    """The three stage stacks, the sigmoid gates and the three deblock sets
    with per-level ego attention over 3 slots (one absent)."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (3, 16, 16, 16)).astype(np.float32)
    lx, rx = x[..., :8], x[..., 8:]
    am = np.array([[True, True, False]])
    cfg = dict(layer_nums=(1, 1), layer_strides=(2, 2), num_filters=(16, 32),
               upsample_strides=(1, 2), num_upsample_filters=(16, 16))
    jm = _JaxMGF(cfg)
    var = random_variables(jm, x, lx, rx, am, seed=3)
    want = np.asarray(jm.apply(var, x, lx, rx, am))
    port = MGFBackbone(8, *cfg.values()).eval()
    load_flax_variables(port, {c: var[c]["mgf"] for c in var})
    tam = torch.from_numpy(am)
    with torch.no_grad():
        got = port(*(nhwc_to_nchw(a) for a in (x, lx, rx)),
                   lambda f: ego_agent_attention(f.unflatten(0, (1, 3)), tam))
    assert got.shape[1] == port.out_channels == 16 * 2 + 2 * 8 * 2
    assert_close(nchw_to_nhwc(got), want, atol=TOL * (1 + np.abs(want).max()),
                 rtol=0)


def test_spatialcooper_fuse_matches_jax(batch, runs):
    """The max / mean volume through the Conv3d on random agent maps: the
    flax (3, 3, 3, 2, 1) kernel bridged to torch's (1, 2, 3, 3, 3)."""
    h, var, _ = runs("point_pillar_spatialcooper")
    assert var["params"]["spatial_fuse3d"]["kernel"].shape == (3, 3, 3, 2, 1)
    grouped = np.random.default_rng(4).normal(0, 1, (2, 3, 8, 8, 32)).astype(
        np.float32)
    jm = jax_build_model(h)
    am = batch["agent_mask"]
    want, rate = jm.apply(var, jnp.asarray(grouped), {"agent_mask": jnp.asarray(am)},
                          False, method=jm.fuse)
    model = build_model(h, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got, trate = model.fuse(
            torch.from_numpy(grouped).permute(0, 1, 4, 2, 3),
            {"agent_mask": torch.from_numpy(am)})
    assert model.spatial_fuse3d.weight.shape == (1, 2, 3, 3, 3)
    want = np.asarray(want)
    assert_close(nchw_to_nhwc(got), want, atol=TOL * (1 + np.abs(want).max()),
                 rtol=0)
    assert float(trate) == float(rate) == 1.0


def test_sicp_dual_heads_match_jax_in_train_mode(batch, runs):
    """Flat SiCP in train mode: the fused heads, the ego alone through the
    shared heads (psm1 / rm1) and psm2 / rm2 equal to the fused ones; eval
    mode emits the fused heads only."""
    h, var, _ = runs("point_pillar_sicp")
    jm = jax_build_model(h)
    want, _ = jax.jit(lambda v, b: jm.apply(v, b, train=True,
                                            mutable=["batch_stats"]))(
        var, jax.tree.map(jnp.asarray, _scene(batch)))
    model = build_model(h, device="cpu", train=True)
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    assert set(got) == set(want) == {"psm", "rm", "comm_rate", "psm1", "rm1",
                                     "psm2", "rm2"}
    for k in ("psm", "rm", "psm1", "rm1", "psm2", "rm2"):
        w = np.asarray(want[k])
        assert_close(got[k].numpy(), w, atol=TOL * (1 + np.abs(w).max()), rtol=0,
                     what=k)
    assert np.abs(np.asarray(want["psm1"]) - np.asarray(want["psm"])).max() > 1e-3
    assert set(runs("point_pillar_sicp")[2]) == {"psm", "rm", "comm_rate"}


# --- one train step each --------------------------------------------------


@pytest.fixture(scope="module", params=TRAIN)
def step_run(request, batch, runs):
    h, var, _ = runs(request.param)
    params, stats, jparts, grads = jax_step(h, batch, var, dtype=jnp.float64)
    model, parts = port_step(h, batch, var)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(h, grads, stats), after=twin(h, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"])


def test_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100) > 0
