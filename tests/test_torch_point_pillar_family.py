"""The flat OPV2V / DAIR-V2X ``point_pillar_*`` family of the port against
the JAX package on the CPU: every registered name's forward through the
weight bridge in both conv modes, ``point_pillar_loss``, one
``make_train_step`` update of each model class, and the 18 OPV2V / DAIR
YAMLs of the family at full width through the registry and the bridge.

The tiny configs are tests/test_point_pillar_family.py's (``_hypes``,
``EXTRAS``: 3 slots, a 64 x 64 grid, 16 / 32 channels, a 1x1 shrink, maps
of 32 x 32), with a V2X-ViT block at 32 channels (``V2XVIT``), Max with the
``v2vfusion`` ego warp, and ``baseline_multiscale`` on both backbones and
both fusions. The scene has an absent slot and perturbed poses, so the
warps move features.

The train steps take a labelled pair of such scenes (the second's third
slot absent). The reference of each step is JAX's float64 step where it
jits: JAX's own f32 loss lies up to 2.0e-5 (relative) from it on these
models, beyond the step tolerance STEP_LOSS_TOL, the port's f32 within
2.1e-7 (gradients within 4e-4 of their bound). XLA's CPU jit miscompiles
the V2VNet and When2com fusions, whose float64 steps run for minutes
eagerly: those two are held to JAX's f32 step at XLA_OPT0
(tests/torch_train_helpers.py), When2com's gradients at JAX_F32_GRAD_TOL as
in tests/test_torch_train_eager.py. Single-scale Where2comm trains at a
keep fraction whose cut lies on a confidence gap of at least 1e-5 in every
present agent.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.where2comm import gaussian_smooth
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import flax_state_dict, load_flax_variables
from tests.test_point_pillar_family import EXTRAS, _hypes
from tests.test_torch_train_eager import JAX_F32_GRAD_TOL
from tests.torch_port_helpers import REPO, one_torch_thread, random_variables
from tests.torch_train_helpers import (
    XLA_OPT0, check_gradients, check_loss_parts, check_params_and_stats,
    jax_step, port_step, run_both, twin)

TOL = 1e-4  # whole-model outputs, f32, x (1 + scale)
RANGE = [-12.8, -12.8, -3, 12.8, 12.8, 1]
V2XVIT = {"encoder": {
    "num_blocks": 1, "depth": 1, "use_roi_mask": True, "use_RTE": True,
    "RTE_ratio": 2,
    "cav_att_config": {"dim": 32, "use_hetero": True, "use_RTE": True,
                       "RTE_ratio": 2, "heads": 2, "dim_head": 16,
                       "dropout": 0.0},
    "pwindow_att_config": {"dim": 32, "heads": [2, 1, 1],
                           "dim_head": [16, 32, 32], "window_size": [2, 4, 4],
                           "relative_pos_embedding": True,
                           "fusion_method": "split_attn", "dropout": 0.0},
    "feed_forward": {"mlp_dim": 32, "dropout": 0.0},
    "sttf": {"voxel_size": [0.4, 0.4, 4], "downsample_rate": 2}}}

# case -> (registry name, extra model args, ResNet backbone)
CASES = {name: (name, EXTRAS[name], False) for name in EXTRAS
         if name != "point_pillar_disconet"}
CASES.update({
    "point_pillar_attfusion": ("point_pillar_attfusion", {}, False),
    "point_pillar_fcooper": ("point_pillar_fcooper", {}, False),
    "point_pillar_max-warp": ("point_pillar_max", {"v2vfusion": {
        "voxel_size": [0.4, 0.4, 4], "downsample_rate": 2}}, False),
    "point_pillar_v2xvit": ("point_pillar_v2xvit", {"transformer": V2XVIT}, False),
    "point_pillar_baseline_multiscale": (
        "point_pillar_baseline_multiscale", {"fusion_method": "att"}, True),
    "point_pillar_baseline_multiscale-max-plain": (
        "point_pillar_baseline_multiscale", {}, False),
})
# one train step per model class
TRAIN = ("point_pillar", "point_pillar_intermediate", "point_pillar_max-warp",
         "point_pillar_where2comm", "point_pillar_v2xvit", "point_pillar_cobevt",
         "point_pillar_v2vnet", "point_pillar_when2com",
         "point_pillar_baseline_multiscale")
MISCOMPILED = ("point_pillar_v2vnet", "point_pillar_when2com")
KEEP_TARGET = 0.6  # Where2comm's keep fraction, moved to a clear cut
CUT_GAP = 1e-5


def tiny_hypes(case):
    name, extra, resnet = CASES[case]
    h = _hypes(name, copy.deepcopy(extra))
    h["model"]["args"]["base_bev_backbone"]["resnet"] = resnet
    h["postprocess"] = {
        "anchor_args": {"cav_lidar_range": list(RANGE), "l": 3.9, "w": 1.6,
                        "h": 1.56, "r": [0, 90], "feature_stride": 2, "num": 2,
                        "vw": 0.4, "vh": 0.4, "vd": 4, "W": 64, "H": 64, "D": 1},
        "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                        "score_threshold": 0.2},
        "order": "hwl", "max_num": 20, "nms_thresh": 0.15}
    h["optimizer"] = {"core_method": "Adam", "lr": 0.002,
                      "args": {"eps": 1e-10, "weight_decay": 1e-4}}
    h["lr_scheduler"] = {"core_method": "multistep", "gamma": 0.1,
                         "step_size": [15, 30]}
    h["train_params"] = {"max_cav": 3, "batch_size": 2}
    return h


@pytest.fixture(scope="module")
def batch():
    """Two labelled tiny scenes (JAX ``make_batch``, seed 3), the second's
    third slot absent, poses perturbed (seed 2)."""
    h = tiny_hypes("point_pillar")
    anchors = generate_anchor_grid(h["postprocess"]["anchor_args"])
    b, _ = jax_make_batch(
        np.random.default_rng(3), JaxSlotLayout(counts=(3, 0, 0)), 2,
        anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=h["postprocess"]["target_args"], num_objects=4,
        points_per_agent=512, lidar_range=RANGE, max_boxes=20, pts_per_box=40)
    b["agent_mask"][1, 2] = False
    b["points_mask"][1, 2] = False
    return perturb_poses(b, np.random.default_rng(2))


def _scene(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.fixture(scope="module")
def variables(batch):
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = random_variables(
                jax_build_model(tiny_hypes(case)),
                jax.tree.map(jnp.asarray, _scene(batch)), seed=5, train=False)
        return cache[case]

    return get


@pytest.fixture(scope="module")
def jax_outputs(batch, variables):
    cache = {}

    def get(case):
        if case not in cache:
            model = jax_build_model(tiny_hypes(case))
            out = jax.jit(lambda v, b: model.apply(v, b, train=False))(
                variables(case), jax.tree.map(jnp.asarray, _scene(batch)))
            cache[case] = jax.tree.map(np.asarray, out)
        return cache[case]

    return get


def test_registry_has_the_family():
    names = {n for n, _, _ in CASES.values()}
    assert names <= set(MODEL_REGISTRY) and len(names) == 11


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(batch, variables, jax_outputs, case, mode,
                             monkeypatch):
    """psm / rm / comm_rate of the port's f32 model (``pallas``: the conv
    kernel's plain version) against JAX's from the same flax variables."""
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    model = build_model(tiny_hypes(case), device="cpu")
    load_flax_variables(model, variables(case))
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    want = jax_outputs(case)
    for k in ("psm", "rm"):
        w = want[k]
        assert got[k].shape == w.shape == ((2, 32, 32, 2) if k == "psm"
                                           else (2, 32, 32, 14))
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=TOL * (1 + np.abs(w).max()), err_msg=k)
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                     rel=1e-6)


@pytest.mark.parametrize("prefix", ["", "_single_v"])
def test_point_pillar_loss_matches_jax(prefix):
    """``point_pillar_loss`` parts on random logits and labels with a few
    positives per sample, to 1e-6 relative."""
    rng = np.random.default_rng(11)
    out = {f"psm{prefix}": rng.normal(size=(3, 16, 24, 2)).astype(np.float32),
           f"rm{prefix}": rng.normal(size=(3, 16, 24, 14)).astype(np.float32)}
    pos = (rng.uniform(size=(3, 16, 24, 2)) < 0.02).astype(np.float32)
    pos[2] = 0.0  # a sample without positives
    tgt = {"pos_equal_one": pos,
           "targets": rng.normal(size=(3, 16, 24, 14)).astype(np.float32)}
    cfg = {"loss": {"core_method": "point_pillar_loss",
                    "args": {"cls_weight": 1.5, "reg": 2.0}},
           "model": {"args": {}}}
    _, want = jax_build_loss(cfg)(jax.tree.map(jnp.asarray, out),
                                  jax.tree.map(jnp.asarray, tgt), prefix)
    _, got = build_loss(cfg)({k: torch.from_numpy(v) for k, v in out.items()},
                             {k: torch.from_numpy(v) for k, v in tgt.items()},
                             prefix)
    assert set(got) == set(want) == {f"{p}{prefix}" for p in
                                     ("total_loss", "conf_loss", "reg_loss")}
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


# --- one train step per model class -----------------------------------------


def keep_fraction(h, var, batch):
    """A keep fraction near KEEP_TARGET whose cut k = floor(u * H * W) lies
    on a relative confidence gap of at least CUT_GAP in every present agent
    of every sample (train-mode confidences of the port's float64 model)."""
    model = build_model(h, device="cpu", train=True).double()
    load_flax_variables(model, jax.tree.map(lambda a: np.asarray(a, np.float64),
                                            var))
    b = batch_to_torch(jax.tree.map(lambda a: a.astype(np.float64)
                                    if a.dtype == np.float32 else a,
                                    _scene(batch)), "cpu")
    with torch.no_grad():
        grouped = model.backbone_2d(model.encode(b))
        psm = model.cls_head(grouped.flatten(0, 1))
    conf = gaussian_smooth(torch.sigmoid(psm).amax(1), 3, 1.0)
    conf = conf.reshape(2, 3, -1)[b["agent_mask"]]
    srt = conf.sort(-1, descending=True)[0]
    gap = ((srt[:, :-1] - srt[:, 1:]) / srt[:, :-1].abs().clamp_min(1e-30))
    gaps = gap.min(0)[0].numpy()
    hw = gaps.shape[0] + 1
    ks = np.nonzero(gaps > CUT_GAP)[0] + 1
    k = ks[np.argmin(np.abs(ks - KEEP_TARGET * hw))]
    assert abs(k - KEEP_TARGET * hw) < 0.05 * hw
    return float(np.float32((k + 0.5) / hw))


@pytest.fixture(scope="module", params=TRAIN)
def step_run(request, batch, variables):
    case = request.param
    h = tiny_hypes(case)
    var = variables(case)
    u = keep_fraction(h, var, batch) if case == "point_pillar_where2comm" else None
    if case in MISCOMPILED:
        run = run_both(h, h, batch, var, u=u, compiler_options=XLA_OPT0)
        if case == "point_pillar_when2com":
            run["grad_tol"] = JAX_F32_GRAD_TOL
        return run
    params, stats, jparts, grads = jax_step(h, batch, var, u=u,
                                            dtype=jnp.float64)
    model, parts = port_step(h, batch, var, u=u)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(h, grads, stats), after=twin(h, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_train_step_gradients_match_jax(step_run):
    kw = {"tol": step_run["grad_tol"]} if "grad_tol" in step_run else {}
    check_gradients(step_run["model"], step_run["grads"], **kw)


def test_train_step_params_and_bn_stats_match_jax(step_run):
    kw = {"grad_tol": step_run["grad_tol"]} if "grad_tol" in step_run else {}
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100, **kw) > 0


# --- the family's YAMLs at full width -----------------------------------------

YAMLS = [f"opv2v/opv2v_{n}.yaml" for n in (
    "single", "attfuse", "fcooper", "where2comm", "v2xvit", "cobevt", "v2vnet",
    "when2com", "baseline_multiscale")] + [f"dair-v2x/dair_{n}.yaml" for n in (
        "single", "attfuse", "fcooper", "where2comm", "v2xvit", "cobevt",
        "v2vnet", "when2com")]


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_and_bridges_at_full_width(path):
    """The config as the registry builds it (on the meta device: no weight
    is materialised) against the JAX model's abstract init: the bridge's
    names and shapes equal the port's state_dict, strict. DAIR's 504 x 200
    grid gives When2com MLPs of 25 x 63 x 256 inputs, not its config's
    H x W."""
    full = os.path.join(REPO, "hypes_yaml", path)
    jh, th = jax_load_yaml(full), load_yaml(full)
    l = int(jh["model"]["args"]["max_cav"])
    batch = {"points": jax.ShapeDtypeStruct((1, l, 64, 4), jnp.float32),
             "points_mask": jax.ShapeDtypeStruct((1, l, 64), jnp.bool_),
             "agent_mask": jax.ShapeDtypeStruct((1, l), jnp.bool_),
             "pairwise_t": jax.ShapeDtypeStruct((1, l, 4, 4), jnp.float32),
             "pairwise_t_full": jax.ShapeDtypeStruct((1, l, l, 4, 4), jnp.float32),
             "prior_encoding": jax.ShapeDtypeStruct((1, l, 3), jnp.float32)}
    jmodel = jax_build_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)}, b,
        train=False), batch)
    zero = np.zeros((), np.float32)
    views = jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes)
    args = dict(th["model"]["args"], preprocess=th["preprocess"],
                postprocess=th["postprocess"])
    with torch.device("meta"):
        model = MODEL_REGISTRY[th["model"]["core_method"]](args)
    sd = flax_state_dict(model, views)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    grid = (200, 704) if path.startswith("opv2v") else (200, 504)
    assert model.feature_hw == (grid[0] // 2, grid[1] // 2)
    if th["model"]["core_method"] == "point_pillar_when2com":
        assert model.fusion_net.key_net.fc[0].in_features == (
            25 * (grid[1] // 8) * 256)
