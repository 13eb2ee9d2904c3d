"""The PyTorch port's host-side copies and its weight bridge against the JAX
package: config loading, synthetic scenes, the anchor grid, the flax ->
torch bridge, the import rule and the device rule."""

import ast
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops.anchors import generate_anchor_grid as jax_anchor_grid
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import FLAGSHIP, REPO, TINY, random_variables

CONFIGS = [TINY, FLAGSHIP]


def _assert_same_tree(a, b, path="hypes"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["tiny", "flagship"])
def test_load_yaml_matches_jax(cfg):
    _assert_same_tree(load_yaml(cfg), jax_load_yaml(cfg))


@pytest.mark.parametrize("cfg", CONFIGS, ids=["tiny", "flagship"])
def test_make_scene_bit_identical(cfg):
    hypes = load_yaml(cfg)
    args = hypes["model"]["args"]
    assert SlotLayout.from_args(args) == SlotLayout(
        JaxSlotLayout.from_args(args).counts)
    kw = dict(num_objects=7, points_per_agent=1500, pts_per_box=80,
              lidar_range=hypes["preprocess"]["cav_lidar_range"],
              num_agents={"vehicle": 2, "rsu": 1, "drone": 1})
    got = make_scene(np.random.default_rng(5), SlotLayout.from_args(args), **kw)
    want = jax_make_scene(np.random.default_rng(5), JaxSlotLayout.from_args(args),
                          **kw)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["tiny", "flagship"])
def test_anchor_grid_identical(cfg):
    aa = load_yaml(cfg)["postprocess"]["anchor_args"]
    got, want = generate_anchor_grid(aa), jax_anchor_grid(aa)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def tiny_variables():
    hypes = jax_load_yaml(TINY)
    model = jax_build_model(hypes)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(0), layout, points_per_agent=256,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"])
    batch = {k: jnp.asarray(v[None]) for k, v in b.items()}
    return random_variables(model, batch, seed=1, train=False)


def test_bridge_consumes_every_leaf(tiny_variables):
    model = build_model(load_yaml(TINY), device="cpu")
    load_flax_variables(model, tiny_variables)  # raises on any leftover
    n_leaves = sum(len(v) for col in tiny_variables.values()
                   for v in _leaves(col))
    n_tensors = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers()
        if not n.endswith("num_batches_tracked"))
    assert n_leaves == n_tensors  # shared modules are registered once
    bn = model.backbone.stages[1].layers[0].bn
    want = tiny_variables["batch_stats"]["backbone"]["stages_1"][
        "ConvBNReLU_0"]["BatchNorm_0"]["var"]
    np.testing.assert_array_equal(bn.running_var.numpy(), want)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield np.ravel(v)


def test_bridge_raises_on_leftover_or_missing(tiny_variables):
    model = build_model(load_yaml(TINY), device="cpu")
    extra = {**tiny_variables,
             "params": {**tiny_variables["params"], "stray": {"kernel": np.ones(3)}}}
    with pytest.raises(ValueError, match="stray"):
        load_flax_variables(model, extra)
    heads = dict(tiny_variables["params"]["heads"])
    del heads["obj_head"]
    missing = {**tiny_variables,
               "params": {**tiny_variables["params"], "heads": heads}}
    with pytest.raises(KeyError, match="obj_head"):
        load_flax_variables(model, missing)


_FORBIDDEN = ("jax", "flax", "airv2x_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax():
    files = glob.glob(os.path.join(REPO, "airv2x_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(REPO, "chip_smoke.py")]
    assert len(files) > 20
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in _FORBIDDEN, f"{path} imports {name}"


def test_entry_points_need_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    hypes = load_yaml(TINY)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(hypes)
    with pytest.raises(RuntimeError, match="CUDA"):
        batch_to_torch({"points": np.zeros((1, 4), np.float32)})
