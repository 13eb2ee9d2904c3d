"""The V2X-R YAMLs in the port against the JAX package on the CPU:

  * all 29 YAMLs (8 under ``LiDAR/``, 10 under ``L_4DR_Fusion/``, 10 under
    ``4DRadar/``, MDD's under ``L_4DR_Fusion_with_MDD/``) built through the
    registry at full width on the meta device (no weight materialised)
    against the JAX model's abstract init: the bridge's names and shapes
    equal the port's state_dict, strict;
  * RTNH and MDD build through the registry and MDD's training dataset
    reads the clean-point mask;
  * the ``4DRadar/`` twins of attfuse, cobevt, coalign, scope, sicp, v2xvit
    and where2comm compute what their ``LiDAR/`` twins compute: their model
    sections differ only in ``use_modality``, which only PFA-Net and
    SpatialCooper read (in both packages' sources), and the port's tiny
    models give equal outputs with and without the key on a batch that
    carries a radar cloud.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.opv2v_dataset import OPV2VDataset
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import flax_state_dict, init_random_
from tests.test_torch_point_pillar_family import tiny_hypes
from tests.test_torch_v2xr_models import SICP
from tests.torch_port_helpers import CHIP_SMOKE, REPO, one_torch_thread  # noqa: F401

V2XR = os.path.join(REPO, "hypes_yaml", "V2X-R")
# RTNH's and MDD's YAMLs
RTNH_MDD = ("4DRadar/V2XR_RTNH.yaml", "L_4DR_Fusion_with_MDD/V2XR_AttFuse.yaml")
YAMLS = sorted(os.path.relpath(p, V2XR) for p in glob.glob(
    os.path.join(V2XR, "*", "*.yaml")))
TWINS = ("attfuse", "cobevt", "coalign", "scope", "sicp", "v2xvit", "where2comm")


def test_the_in_scope_yamls_are_27():
    """All 29: every directory's YAMLs, RTNH's and MDD's among them."""
    dirs = [p.split("/")[0] for p in YAMLS]
    assert (len(YAMLS), dirs.count("LiDAR"), dirs.count("L_4DR_Fusion"),
            dirs.count("4DRadar"), dirs.count("L_4DR_Fusion_with_MDD")) == (
                29, 8, 10, 10, 1)
    assert set(RTNH_MDD) <= set(YAMLS)
    names = {load_yaml(os.path.join(V2XR, p))["model"]["core_method"]
             for p in YAMLS}
    assert names <= set(MODEL_REGISTRY)


def _abstract_batch(hypes):
    """A small batch of one scene, with a radar cloud per agent, as shapes;
    SCOPE's with 2 frames (``chip_smoke.scope_scene``) and the radar
    without a time axis, as the dataset gives it."""
    l = int(hypes["model"]["args"]["max_cav"])
    lr = hypes["preprocess"]["cav_lidar_range"]
    kw = dict(points_per_agent=64, pts_per_box=8, num_agents={"vehicle": l})
    layout = JaxSlotLayout(counts=(l, 0, 0))
    b, _ = jax_make_scene(np.random.default_rng(0), layout, lidar_range=lr,
                          radar_points_per_agent=16, **kw)
    b = {k: v[None] for k, v in b.items()}
    if "scope" in hypes["model"]["core_method"]:
        scope = CHIP_SMOKE.scope_scene(np.random.default_rng(0), layout, 2, lr,
                                       **kw)
        b.update(scope)
    return jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), b)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_and_bridges_at_full_width(path):
    full = os.path.join(V2XR, path)
    jh, th = jax_load_yaml(full), load_yaml(full)
    jmodel = jax_build_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)}, b,
        train=False), _abstract_batch(jh))
    zero = np.zeros((), np.float32)
    views = jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes)
    args = dict(th["model"]["args"], preprocess=th["preprocess"],
                postprocess=th["postprocess"])
    with torch.device("meta"):
        model = MODEL_REGISTRY[th["model"]["core_method"]](args)
    sd = flax_state_dict(model, views)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    name = th["model"]["core_method"]
    assert ("radar_vfe" in dict(model.named_children())) == any(
        k in name for k in ("lrf", "l4dr"))
    if name == "point_pillar_l4dr":  # 3 levels x (128 + 64 + 64) -> 256
        assert model.shrink_conv.blocks[0].conv0.weight.shape[1] == 768
    if name == "point_pillar_interf":
        assert not hasattr(model, "vfe")
        assert model.backbone.stages[0].layers[0].conv.weight.shape[1] == 128


@pytest.mark.parametrize("path", RTNH_MDD)
def test_rtnh_and_mdd_raise_naming_item_7(path):
    """Both build through the registry (on the meta device: no weight
    materialised), and MDD's training dataset reads the clean-point mask."""
    hypes = load_yaml(os.path.join(V2XR, path))
    args = dict(hypes["model"]["args"], preprocess=hypes["preprocess"],
                postprocess=hypes["postprocess"])
    with torch.device("meta"):
        model = MODEL_REGISTRY[hypes["model"]["core_method"]](args)
    assert model.layout.total == 5
    if "MDD" in path:
        assert OPV2VDataset(hypes, "", train=True, use_radar=True).with_de


def test_only_pfanet_and_spatialcooper_read_use_modality():
    """Both packages' sources: the key is read in the attention-backbone
    module only (and, in the port, by the train CLI's refusal)."""
    for pkg, allowed in (("airv2x_tpu", {"models/att_backbone_models.py"}),
                         ("airv2x_tpu_torch", {"models/att_backbone_models.py",
                                               "tools/train.py"})):
        root = os.path.join(REPO, pkg)
        readers = {os.path.relpath(p, root) for p in glob.glob(
            os.path.join(root, "**", "*.py"), recursive=True)
            if "use_modality" in open(p).read()}
        assert readers == allowed, (pkg, readers)


def _tiny_twin(name):
    """The tiny model of a 4DRadar / LiDAR twin pair and its batch (one
    scene with a radar cloud; SCOPE's 2 frames)."""
    from airv2x_tpu_torch.data.synthetic import make_scene
    from airv2x_tpu_torch.models.base import SlotLayout

    layout = SlotLayout(counts=(3, 0, 0))
    if name == "scope":
        h = CHIP_SMOKE.tiny_scope_hypes()
        b = CHIP_SMOKE.scope_scene(np.random.default_rng(0), layout, 2,
                                   CHIP_SMOKE.TINY_SCOPE_RANGE,
                                   pose_rng=np.random.default_rng(1),
                                   points_per_agent=512)
        radar, _ = make_scene(np.random.default_rng(2), layout,
                              lidar_range=CHIP_SMOKE.TINY_SCOPE_RANGE,
                              points_per_agent=512, radar_points_per_agent=64)
        b.update({k: radar[k][None] for k in ("radar_points",
                                              "radar_points_mask")})
        return h, b
    case = {"attfuse": "point_pillar_intermediate",
            "coalign": "point_pillar_intermediate", "sicp": "point_pillar"}.get(
                name, f"point_pillar_{name}")
    h = tiny_hypes(case)
    h["model"]["core_method"] = {"attfuse": "point_pillar_intermediate",
                                 "sicp": "point_pillar_sicp",
                                 "coalign": "point_pillar_coalign"}.get(name, case)
    if name == "sicp":
        h["model"]["args"].update(SICP)
    b, _ = make_scene(np.random.default_rng(3), layout, num_objects=4,
                      points_per_agent=512, lidar_range=h["preprocess"][
                          "cav_lidar_range"], radar_points_per_agent=64)
    return h, {k: v[None] for k, v in b.items()}


def _plain(tree):
    """A loaded config with its arrays as lists, comparable with ==."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree.tolist() if isinstance(tree, np.ndarray) else tree


@pytest.mark.parametrize("name", TWINS)
def test_4dradar_twin_computes_what_the_lidar_twin_computes(name):
    radar = load_yaml(os.path.join(V2XR, f"4DRadar/V2XR_{name}.yaml"))["model"]
    lidar = load_yaml(os.path.join(V2XR, f"LiDAR/V2XR_{name}.yaml"))["model"]
    assert radar["args"].pop("use_modality") == "processed_radar"
    assert _plain(radar) == _plain(lidar)
    h, b = _tiny_twin(name)
    batch = batch_to_torch(b, "cpu")
    outs = []
    for key in ({}, {"use_modality": "processed_radar"}):
        h["model"]["args"].pop("use_modality", None)
        h["model"]["args"].update(key)
        model = init_random_(build_model(h, device="cpu"), seed=1)
        with torch.no_grad():
            outs.append(model(batch))
    for k in ("psm", "rm"):
        assert torch.equal(outs[0][k], outs[1][k]), k
        assert torch.isfinite(outs[0][k]).all()
