"""The ten shipped early-fusion and BM2CP YAMLs in the PyTorch port: each
builds through the registry at full width on the meta device (no weight
is materialised), and the weight bridge consumes every leaf of the JAX
model's variables and fills every tensor of the port's, names and shapes
equal (strict). The JAX variables' shapes come from ``jax.eval_shape`` of
the flax init on an abstract batch: for BM2CP one camera per slot at the
YAML's ``final_dim``, with its depth maps; the AirV2X slots cut to one per
type on both sides (no tensor's shape depends on the slot count).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import flax_state_dict
from tests.torch_port_helpers import REPO

YAMLS = ["airv2x/lidar/det/early.yaml", "airv2x/camera/det/early.yaml",
         "opv2v/opv2v_early.yaml", "dair-v2x/dair_early.yaml",
         "opv2v/opv2v_disconet_teacher.yaml", "airv2x/lidar/det/bm2cp.yaml",
         "airv2x/lidar/seg/bm2cp.yaml", "airv2x/camera/det/bm2cp.yaml",
         "opv2v/opv2v_bm2cp.yaml", "dair-v2x/dair_bm2cp.yaml"]
NAMES = {"point_pillar_early", "airv2x_early", "point_pillar_disconet_teacher",
         "airv2x_bm2cp", "point_pillar_bm2cp"}


def _cut(hypes):
    """An AirV2X config's slots cut to one per present type."""
    args = hypes["model"]["args"]
    if isinstance(args.get("max_cav"), dict):
        args["max_cav"] = {t: min(int(n), 1) for t, n in args["max_cav"].items()}
    return hypes


def _abstract_batch(hypes):
    args = hypes["model"]["args"]
    if isinstance(args["max_cav"], dict):
        layout = JaxSlotLayout.from_args(args)
    else:
        layout = JaxSlotLayout(counts=(int(args["max_cav"]), 0, 0))
    l = layout.total

    def s(shape, dtype=jnp.float32):
        return jax.ShapeDtypeStruct(shape, dtype)

    batch = {"points": s((1, l, 64, 4)), "points_mask": s((1, l, 64), jnp.bool_),
             "agent_mask": s((1, l), jnp.bool_), "pairwise_t": s((1, l, 4, 4)),
             "pairwise_t_full": s((1, l, l, 4, 4)), "prior_encoding": s((1, l, 3))}

    def cam(h, w, c=3, depth=True):
        block = {"imgs": s((1, l, 1, h, w, c)), "intrinsics": s((1, l, 1, 3, 3)),
                 "rots": s((1, l, 1, 3, 3)), "trans": s((1, l, 1, 3)),
                 "post_rots": s((1, l, 1, 3, 3)), "post_trans": s((1, l, 1, 3))}
        if depth:
            block["depth_maps"] = s((1, l, 1, h, w))
        return block

    core = hypes["model"]["core_method"]
    if core == "point_pillar_bm2cp":
        batch["cam_vehicle"] = cam(*args["img_params"]["data_aug_conf"]["final_dim"])
    elif core == "airv2x_bm2cp":
        for t in ("vehicle", "rsu", "drone"):
            conf = args[t] if t == "drone" else args[t]["img_params"]
            c = 4 if t == "drone" and conf.get("use_depth_gt") else 3
            batch[f"cam_{t}"] = cam(*conf["data_aug_conf"]["final_dim"], c=c,
                                    depth=t != "drone")
    return batch


def test_the_names_are_registered():
    found = {jax_load_yaml(os.path.join(REPO, "hypes_yaml", p))["model"]["core_method"]
             for p in YAMLS}
    assert found == {"airv2x_early", "point_pillar_early",
                     "point_pillar_disconet_teacher", "airv2x_bm2cp",
                     "point_pillar_bm2cp"}
    assert NAMES <= set(MODEL_REGISTRY)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_and_bridges_at_full_width(path):
    full = os.path.join(REPO, "hypes_yaml", path)
    jh, th = _cut(jax_load_yaml(full)), _cut(load_yaml(full))
    jmodel = jax_build_model(jh)
    shapes = jax.eval_shape(lambda b: jmodel.init(
        {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)}, b,
        train=False), _abstract_batch(jh))
    zero = np.zeros((), np.float32)
    views = jax.tree.map(lambda x: np.broadcast_to(zero, x.shape), shapes)
    args = dict(th["model"]["args"], preprocess=th["preprocess"],
                postprocess=th["postprocess"])
    with torch.device("meta"):
        model = MODEL_REGISTRY[th["model"]["core_method"]](args)
    sd = flax_state_dict(model, views)  # raises on a leaf it does not consume
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(t.shape) for k, t in model.state_dict().items()}
    core = th["model"]["core_method"]
    if core == "airv2x_bm2cp":
        # the classic pillar path (a PFN of 64), the EfficientNet lift into
        # 48 depth bins x 64 channels, the ResNet 3 / 4 / 5 at 64-256
        enc = model.veh_model
        assert enc.vfe.pfn[0].linear.weight.shape == (64, 10)
        assert enc.camencode.depth_head.weight.shape[0] == 48
        assert [len(s.blocks) for s in model.backbone.stages] == [3, 4, 5]
    elif core == "point_pillar_bm2cp":
        assert model.fast_pillars and model.camencode.image_head.weight.shape[0] == 64
    else:
        assert model.fast_pillars  # early: one K1 launch on the merged cloud
