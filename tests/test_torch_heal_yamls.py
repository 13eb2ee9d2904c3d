"""The 28 shipped HEAL, STAMP and SiCP YAMLs (LiDAR and camera, det and
seg, stage-1 single-type and collab) in the PyTorch port: each builds
through the registry at full width. For the ten serving configs (the six
``collab.yaml`` and the four ``sicp.yaml``) the weight bridge consumes
every leaf of the JAX model's variables and fills every tensor of the
port's, names and shapes equal (strict); each stage-1 ``single/<type>.yaml``
model holds exactly its collab model's tensors of the shared modules and of
its own type's encoder (and adapter), names and shapes equal, which the
multi-stage recipe's ``merge_compatible`` copies.

The JAX variables' shapes come from ``jax.eval_shape`` of the flax init on
an abstract batch (camera configs: 256 x 352 images on the reference's
camera rigs); the port's models are built on the meta device, so no weight
is materialised.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import add_camera_inputs as jax_add_camera_inputs
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import flax_state_dict
from tests.torch_port_helpers import REPO, one_torch_thread

YAMLS = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "hypes_yaml/airv2x/**/*.yaml"), recursive=True)
    if any(k in p for k in ("airv2x_heal", "airv2x_stamp", "sicp.yaml")))


def test_the_shipped_yamls_are_28():
    assert len(YAMLS) == 28
    names = {jax_load_yaml(os.path.join(REPO, p))["model"]["core_method"]
             for p in YAMLS}
    assert names == {"airv2x_heal", "airv2x_stamp", "airv2x_sicp"}


def _abstract_batch(hypes):
    """The abstract batch of a small ``make_scene`` call (batch 1) with, for
    a camera config, each type's camera block at the YAML's ``final_dim``."""
    args = hypes["model"]["args"]
    layout = JaxSlotLayout.from_args(args)
    b, _ = jax_make_scene(np.random.default_rng(0), layout, points_per_agent=64,
                          pts_per_box=8)
    cam = [t for t in ("vehicle", "rsu", "drone")
           if layout.counts[("vehicle", "rsu", "drone").index(t)]
           and "cam" in args[t].get("modalities", [])]
    if cam:
        jax_add_camera_inputs(b, layout, np.random.default_rng(1), img_hw=(8, 8),
                              ncam={"vehicle": 6, "rsu": 4, "drone": 1})
    shapes = jax.tree.map(lambda v: jax.ShapeDtypeStruct((1,) + v.shape, v.dtype), b)
    for t in cam:
        imgs = shapes[f"cam_{t}"]["imgs"]
        hw = tuple(args[t]["cam"]["data_aug_conf"]["final_dim"])
        shapes[f"cam_{t}"]["imgs"] = jax.ShapeDtypeStruct(
            imgs.shape[:3] + hw + imgs.shape[-1:], imgs.dtype)
    return shapes


COLLAB = [p for p in YAMLS if "/single/" not in p]
SINGLE = [p for p in YAMLS if "/single/" in p]


def _port_model(path, cut=None):
    th = load_yaml(os.path.join(REPO, path))
    if cut is not None:
        th = cut(th)
    args = dict(th["model"]["args"], preprocess=th["preprocess"],
                postprocess=th["postprocess"])
    with torch.device("meta"):
        return th, MODEL_REGISTRY[th["model"]["core_method"]](args)


def _one_slot_per_type(hypes):
    """``max_cav`` cut to one slot per present type: no tensor's shape
    depends on the slot count, and SiCP's trace loops over the senders."""
    args = hypes["model"]["args"]
    args["max_cav"] = {t: min(int(n), 1) for t, n in args["max_cav"].items()}
    return hypes


@pytest.mark.parametrize("path", COLLAB)
def test_yaml_builds_and_bridges_at_full_width(path):
    """At full width (grids and channels); the slots cut to one per type
    on both sides (``_one_slot_per_type``)."""
    jh = _one_slot_per_type(jax_load_yaml(os.path.join(REPO, path)))
    jmodel = jax_build_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)}, b,
        train=False), _abstract_batch(jh))
    zero = np.zeros((), np.float32)
    views = jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes)
    th, model = _port_model(path, _one_slot_per_type)
    sd = flax_state_dict(model, views)  # raises on a leaf it does not consume
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    name = th["model"]["core_method"]
    if name == "airv2x_sicp":
        assert model.fusion_net.comp2.conv.weight.shape == (256, 512, 1, 1)
        return
    # the pyramid: ResNeXt 3 / 5 / 8 at 64 / 128 / 256 (widths 128 / 256 /
    # 512 in 32 groups), three deblocks
    block = model.pyramid.resnet.stages[2].blocks[0]
    assert block.conv1.weight.shape == (512, 16, 3, 3)
    assert model.pyramid.out_channels == 384
    assert not model.pyramid.align_corners
    if name == "airv2x_stamp":
        assert all(len(model.get_submodule(f"adapter_{t}").core.blocks) == 3
                   for t in ("vehicle", "rsu", "drone"))


@pytest.mark.parametrize("path", SINGLE)
def test_single_yaml_is_its_collab_model_restricted(path):
    """A stage-1 config builds; its tensors are the collab model's shared
    ones (backbone, pyramid, shrink, heads) and its own type's encoder and
    adapter, names and shapes equal; no other type's."""
    agent = os.path.splitext(os.path.basename(path))[0]
    collab = path.replace(f"single/{agent}.yaml", "collab.yaml")
    th, model = _port_model(path)
    _, full = _port_model(collab)
    assert th["model"]["args"]["max_cav"][agent] == 1
    sd, fsd = model.state_dict(), full.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(fsd[k].shape) for k in fsd
        if not k.startswith(("encoder.", "adapter_"))
        or k.startswith((f"encoder.{agent}_", f"adapter_{agent}."))}
