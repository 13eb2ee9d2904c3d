"""The port's reference-checkpoint converter (``airv2x_tpu_torch/utils/
torch_convert.py``) against the JAX package's on the CPU.

For every converter function of ``CONVERTERS`` (not every one of its 51
names: names that share a function share its map) a tiny model of the port
gives the flax-layout target tree (``utils/weights.py:flax_variables``;
the bridge tests hold these trees leaf for leaf to the JAX models'), and
``reference_state_dict`` writes the reference-named state dict its map
reads. Both packages' ``convert_state_dict`` then run on zeros of the
target's shapes: the assigned, skipped and leftover lists and every
assigned leaf must be the same, with nothing skipped and nothing left over.
``point_pillar_where2comm_bm2cp`` has no model in the port; its target is
the shapes of ``jax.eval_shape`` of the JAX model's ``init``. For the tiny
flagship Where2comm and the flat ``point_pillar_where2comm`` the converted
port model gives the JAX model's outputs on JAX's converted variables
(target shapes from ``eval_shape``, so no init compiles). The loader's
semantics against JAX: ``module.`` stripping, the ``model_state_dict`` /
``state_dict`` wrappers, a shape-mismatch skip and a leftover key.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.utils import torch_convert as jax_tc
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.utils import torch_convert as tc
from airv2x_tpu_torch.utils.weights import flax_variables
from tests.test_torch_mdd import mdd_hypes
from tests.test_torch_point_pillar_family import tiny_hypes as flat_hypes
from tests.test_torch_rtnh import rtnh_hypes
from tests.test_torch_v2xr_models import v2xr_hypes
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread  # noqa: F401

OUT_TOL = 1e-4  # whole-model outputs, f32, x (1 + scale)


def _airv2x(build, *a):
    return lambda: build(load_yaml(TINY), *a)


# converter function -> a tiny config of a registry name it converts
CASES = {
    "convert_airv2x_where2comm": lambda: load_yaml(TINY),
    "convert_airv2x_when2com": _airv2x(CHIP_SMOKE.tiny_family_hypes, "airv2x_when2com"),
    "convert_airv2x_cobevt": _airv2x(CHIP_SMOKE.tiny_family_hypes, "airv2x_cobevt"),
    "convert_airv2x_v2vnet": _airv2x(CHIP_SMOKE.tiny_family_hypes, "airv2x_v2vnet"),
    "convert_airv2x_v2xvit": lambda: CHIP_SMOKE.tiny_v2xvit_hypes("det"),
    "convert_airv2x_heal": _airv2x(CHIP_SMOKE.tiny_hetero_hypes, "airv2x_heal"),
    "convert_airv2x_stamp": _airv2x(CHIP_SMOKE.tiny_hetero_hypes, "airv2x_stamp"),
    "convert_airv2x_sicp": _airv2x(CHIP_SMOKE.tiny_hetero_hypes, "airv2x_sicp"),
    "convert_airv2x_bm2cp": _airv2x(CHIP_SMOKE.tiny_bm2cp_hypes, "airv2x_bm2cp"),
    "convert_point_pillar_bm2cp": _airv2x(CHIP_SMOKE.tiny_bm2cp_hypes,
                                          "point_pillar_bm2cp"),
    "convert_point_pillar_intermediate": lambda: flat_hypes("point_pillar_where2comm"),
    "convert_point_pillar_v2xvit": lambda: flat_hypes("point_pillar_v2xvit"),
    "convert_point_pillar_cobevt": lambda: flat_hypes("point_pillar_cobevt"),
    "convert_point_pillar_v2vnet": lambda: flat_hypes("point_pillar_v2vnet"),
    "convert_point_pillar_when2com": lambda: flat_hypes("point_pillar_when2com"),
    "convert_point_pillar_scope": lambda: CHIP_SMOKE.tiny_scope_hypes(),
    "convert_point_pillar_how2comm": lambda: CHIP_SMOKE.tiny_flat_rest_hypes(
        "point_pillar_how2comm"),
    "convert_point_pillar_coalign": lambda: CHIP_SMOKE.tiny_flat_rest_hypes(
        "point_pillar_coalign"),
    "convert_point_pillar_sicp": lambda: v2xr_hypes("point_pillar_sicp"),
    "convert_point_pillar_attresnet": lambda: v2xr_hypes("point_pillar_attresnet"),
    "convert_point_pillar_l4dr": lambda: v2xr_hypes("point_pillar_l4dr"),
    "convert_point_pillar_interf": lambda: v2xr_hypes("point_pillar_interf"),
    "spatialcooper": lambda: v2xr_hypes("point_pillar_spatialcooper_lrf"),
    "mdd": lambda: mdd_hypes(),
    "convert_rtnh": lambda: rtnh_hypes(load_yaml),
}


def _kind(fn):
    """A converter's map: its code, and for ``_flat_converter``'s closures
    the fusion map they close over (each name gets a closure of its own)."""
    cells = tuple(c.cell_contents.__name__ for c in fn.__closure__ or ()
                  if c.cell_contents is not None)
    return fn.__code__.co_name, fn.__code__.co_firstlineno, cells


def test_every_converter_function_has_a_case():
    """The cases cover every map behind the 51 names, grouped as in JAX."""
    assert list(tc.CONVERTERS) == list(jax_tc.CONVERTERS) and len(tc.CONVERTERS) == 51
    kinds = {n: _kind(f) for n, f in tc.CONVERTERS.items()}
    covered = {kinds[c()["model"]["core_method"]] for c in CASES.values()}
    covered.add(kinds["point_pillar_where2comm_bm2cp"])
    assert covered == set(kinds.values()) and len(covered) == len(CASES) + 1

    def groups(conv):
        out = {}
        for n, f in conv.items():
            out.setdefault((f.__code__.co_name, tuple(
                c.cell_contents.__name__ for c in f.__closure__ or ()
                if c.cell_contents is not None)), set()).add(n)
        return sorted(map(sorted, out.values()))

    assert groups(tc.CONVERTERS) == groups(jax_tc.CONVERTERS)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros(v.shape, np.float32)
            for k, v in tree.items()}


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _same_conversion(sd, target, hypes):
    """Both packages' convert_state_dict of ``sd`` onto zeros of ``target``:
    the same lists and assigned leaves; returns the port's Assigner."""
    got = tc.convert_state_dict(sd, _zeros(target), hypes)
    want = jax_tc.convert_state_dict(sd, _zeros(target), hypes)
    assert got.assigned == want.assigned
    assert got.skipped == want.skipped
    assert got.torch_leftovers == want.torch_leftovers
    for name in got.assigned:
        path = tuple(name.split("/"))
        np.testing.assert_array_equal(_get(got.variables, path),
                                      _get(want.variables, path), err_msg=name)
    return got


# the leaves the reference map leaves to the model's own values in these
# tiny configs, in both packages (ROADMAP.md section 3): no map writes the
# shrink conv of AttResNet, InterF or L4DR; L4DR's map writes its radar
# VFE to the single-layer scope (``radar_vfe/Dense_0``) where the model
# builds ``radar_vfe/PFNLayer_0``; the flat V2VNet's map reads the ConvGRU's
# tensors, which a config with ``gru_flag: false`` does not build
UNMAPPED = {
    "convert_point_pillar_attresnet": ("params/shrink_conv/",),
    "convert_point_pillar_interf": ("params/shrink_conv/",),
    "convert_point_pillar_l4dr": ("params/shrink_conv/", "params/radar_vfe/",
                                  "batch_stats/radar_vfe/"),
}
SKIPPED = {
    "convert_point_pillar_l4dr": ["params/radar_vfe/Dense_0/kernel (missing in target)"],
    "convert_point_pillar_v2vnet": [
        f"params/fusion_net/ConvGRUCell_0/Conv_{i}/kernel (missing in target)"
        for i in (0, 1)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_converter_matches_jax(case):
    hypes = CASES[case]()
    target = flax_variables(build_model(hypes, device="cpu"))
    sd = {k: torch.from_numpy(v) for k, v in
          tc.reference_state_dict(hypes, target, seed=1).items()}
    asg = _same_conversion(sd, target, hypes)
    assert asg.skipped == SKIPPED.get(case, []) and asg.torch_leftovers == []
    # every other parameter and statistic comes from the checkpoint
    left = ["/".join(p) for p, _ in _leaves(target)
            if "/".join(p) not in asg.assigned]
    assert all(k.startswith(UNMAPPED.get(case, ("-",))) for k in left), left
    assert bool(left) == (case in UNMAPPED)


def _flat_scene(hypes, points=256):
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    scene, _ = jax_make_scene(np.random.default_rng(0), layout, num_objects=6,
                              points_per_agent=points,
                              lidar_range=hypes["preprocess"]["cav_lidar_range"])
    return {k: v[None] for k, v in scene.items()}


def _eval_shapes(hypes, batch):
    model = jax_build_model(hypes)
    shapes = jax.eval_shape(
        lambda r, b: model.init(r, b, train=False),
        {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)},
        jax.tree.map(jnp.asarray, batch))
    return model, jax.tree.map(lambda s: s, dict(shapes))


def test_where2comm_bm2cp_converter_matches_jax():
    hypes = flat_hypes("point_pillar_where2comm")
    hypes["model"]["core_method"] = "point_pillar_where2comm_bm2cp"
    args = hypes["model"]["args"]
    bb = args["base_bev_backbone"]
    del bb["resnet"]  # the map reads a ``resnet`` key as a ResNet backbone
    args["fusion_args"] = {
        "voxel_size": [0.4, 0.4, 4], "downsample_rate": 2, "multi_scale": True,
        "agg_operator": {"mode": "Transformer", "n_head": 2, "with_spe": True},
        "num_filters": bb["num_filters"], "layer_nums": bb["layer_nums"],
        "communication": {"thre": 0.01, "gaussian_smooth": {"k_size": 3,
                                                            "c_sigma": 1.0}}}
    _, target = _eval_shapes(hypes, _flat_scene(hypes))
    target = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), target)
    sd = tc.reference_state_dict(hypes, target, seed=2)
    asg = _same_conversion(sd, target, hypes)
    assert asg.skipped == [] and asg.torch_leftovers == []
    assert len(asg.assigned) == sum(1 for _ in _leaves(target))


@pytest.mark.parametrize("name", ["airv2x_where2comm", "point_pillar_where2comm"])
def test_converted_model_matches_jax(name):
    """JAX's converted variables through JAX's model and the converted port
    model give the same outputs on one scene."""
    if name == "airv2x_where2comm":
        jh, th = jax_load_yaml(TINY), load_yaml(TINY)
    else:
        jh = th = flat_hypes(name)
    batch = _flat_scene(jh)
    jmodel, shapes = _eval_shapes(jh, batch)
    port = build_model(th, device="cpu").eval()
    sd = {"module." + k: torch.from_numpy(v)
          for k, v in tc.reference_state_dict(th, shapes, seed=3).items()}
    jasg = jax_tc.convert_state_dict(
        sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), jh)
    asg = tc.load_reference_checkpoint(port, sd, th)
    assert asg.assigned == jasg.assigned and not asg.skipped and not asg.torch_leftovers
    want = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
        jasg.variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = port(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm"):
        w = np.asarray(want[k])
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[k].numpy(), w, atol=OUT_TOL * (1 + scale),
                                   rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    hypes = load_yaml(TINY)
    target = flax_variables(build_model(hypes, device="cpu"))
    return hypes, target, tc.reference_state_dict(hypes, target, seed=4)


@pytest.mark.parametrize("wrap", ["plain", "module.", "model_state_dict",
                                  "state_dict", "module.+state_dict"])
def test_loader_semantics_match_jax(tiny, wrap):
    """The ``module.`` prefix is stripped and the wrapper dicts unwrapped,
    a tensor of the wrong shape is skipped (its target keeps its value),
    and a key no target takes is a leftover, in both packages alike."""
    hypes, target, ref = tiny
    sd = {k: torch.from_numpy(v) for k, v in ref.items()}
    bad = "backbone.blocks.0.1.weight"
    sd[bad] = torch.zeros(sd[bad].shape[0] + 1, *sd[bad].shape[1:])
    sd["not_a_module.weight"] = torch.zeros(3)
    if "module." in wrap:
        sd = {"module." + k: v for k, v in sd.items()}
    key = wrap.split("+")[-1]
    if key.endswith("state_dict"):
        sd = {key: sd, "epoch": 3}
    asg = _same_conversion(sd, target, hypes)
    assert len(asg.skipped) == 1 and "backbone/stages_0/ConvBNReLU_0/Conv_0/kernel" \
        in asg.skipped[0] and "shape" in asg.skipped[0]
    assert asg.torch_leftovers == ["not_a_module.weight"]
    port = build_model(hypes, device="cpu")
    before = copy.deepcopy(port.state_dict())
    tc.load_reference_checkpoint(port, sd, hypes)
    after = port.state_dict()
    assert torch.equal(after["backbone.stages.0.layers.0.conv.weight"],
                       before["backbone.stages.0.layers.0.conv.weight"])
    moved = sum(not torch.equal(after[k], before[k]) for k in before)
    assert moved > 50
