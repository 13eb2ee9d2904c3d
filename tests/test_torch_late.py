"""Late fusion in the PyTorch port against the JAX package on the CPU, and
the flat family's remaining YAMLs.

  * ``decode_late_fusion`` on seeded multiclass head outputs of three agents
    (one absent, perturbed poses): keep sets equal (every NMS IoU asserted
    more than 1e-4 from the threshold), scores, labels and kept corners;
  * both packages refuse binary heads alike (``num_class`` 1: ValueError,
    a binary psm read as 2 classes: TypeError), and neither package's
    ``load_yaml`` gives ``opv2v_late.yaml`` the ``num_class`` that the late
    CLI reads (the port's CLI: KeyError);
  * the late inference CLI against the JAX CLI's ``infer_late`` on the tiny
    config's run dirs (tests/test_torch_eval.py): the same table and yaml;
  * the seven ``{opv2v,dair}_{disconet,how2comm,coalign}`` / ``opv2v_late``
    YAMLs through the registry at full width on the meta device, the weight
    bridge consuming every flax leaf of the JAX model (strict), and the
    registry's 33 names.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.postprocess import decode_late_fusion as jax_decode_late
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.ops.anchors import generate_anchor_grid
from airv2x_tpu.tools import inference as jax_inference
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data.postprocess import decode_late_fusion
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.ops import nms as port_nms
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.tools import inference
from airv2x_tpu_torch.utils.weights import flax_state_dict
from tests.test_torch_eval import _run_dirs
from tests.torch_port_helpers import REPO, TINY, one_torch_thread  # noqa: F401

NMS_MARGIN = 1e-4
L = 3
NUM_CLASS = 4


@pytest.fixture
def nms_ious(monkeypatch):
    """Every IoU matrix the port's NMS computes (the plain version)."""
    seen = []

    def recording(c1, c2, **kw):
        out = quad_iou_plain(c1, c2)
        seen.append(out.triu(1).numpy().copy())
        return out

    monkeypatch.setattr(port_nms, "quad_iou", recording)
    return seen


def _heads(seed=0, num_class=NUM_CLASS):
    """Seeded head outputs of L agents at the tiny config's anchor grid,
    the third agent absent, each agent's pose a rotation of up to 8
    degrees and a shift of up to 3 m."""
    hypes = jax_load_yaml(TINY)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    h, w, a = anchors.shape[:3]
    rng = np.random.default_rng(seed)
    f32 = np.float32
    psm = rng.normal(0, 2, (L, h, w, a * num_class)).astype(f32)
    rm = rng.normal(0, 0.2, (L, h, w, 7 * a)).astype(f32)
    obj = rng.normal(-3, 1.5, (L, h, w, a)).astype(f32)
    pw = np.tile(np.eye(4, dtype=f32), (L, 1, 1))
    for i in range(1, L):
        yaw = np.deg2rad(rng.uniform(-8, 8))
        pw[i, :2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
        pw[i, :2, 3] = rng.uniform(-3, 3, 2)
    mask = np.array([True, True, False])
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], f32)
    kw = dict(num_class=num_class, obj_threshold=0.2,
              nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=256)
    return (psm, rm, obj, anchors.astype(f32), pw, mask, lr), kw


def test_decode_late_fusion_matches_jax(nms_ious):
    args, kw = _heads()
    want = jax_decode_late(*map(jnp.asarray, args), **kw)
    got = decode_late_fusion(*map(torch.from_numpy, args), **kw)
    for iou in nms_ious:
        assert np.abs(iou - kw["nms_thresh"]).min() > NMS_MARGIN
    keep = np.asarray(want.mask)
    assert keep.sum() > 3 and np.array_equal(got.mask.numpy(), keep)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.labels.numpy()[keep],
                                  np.asarray(want.labels)[keep])
    np.testing.assert_allclose(got.corners.numpy()[keep],
                               np.asarray(want.corners)[keep], atol=1e-4)
    # the absent agent contributes nothing; both present ones keep boxes
    per_agent = keep.reshape(L, -1).sum(1)
    assert per_agent[2] == 0 and per_agent[:2].min() > 0


@pytest.mark.parametrize("num_class,error", [(1, ValueError), (2, TypeError)])
def test_binary_heads_are_refused_alike(num_class, error):
    """A binary head (one score per anchor, psm = obj) read as 1 class or as
    2: the JAX decode raises, and the port's raises the same type."""
    args, kw = _heads(num_class=1)
    args = (args[2],) + args[1:]  # psm is the objectness map
    kw["num_class"] = num_class
    with pytest.raises(error):
        jax_decode_late(*map(jnp.asarray, args), **kw)
    with pytest.raises(error):
        decode_late_fusion(*map(torch.from_numpy, args), **kw)


def test_opv2v_late_yaml_has_no_num_class(tmp_path):
    path = os.path.join(REPO, "hypes_yaml/opv2v/opv2v_late.yaml")
    assert "num_class" not in jax_load_yaml(path)
    hypes = load_yaml(path)
    assert "num_class" not in hypes
    save_yaml(hypes, str(tmp_path / "config.yaml"))
    with pytest.raises(KeyError, match="num_class"):
        inference.main(["--model_dir", str(tmp_path), "--device", "cpu",
                        "--fusion_method", "late", "--num_scenes", "1"])


@pytest.fixture(scope="module")
def late_dirs(tmp_path_factory):
    return _run_dirs(str(tmp_path_factory.mktemp("late_runs")), seg=False)


def test_late_cli_matches_jax(late_dirs, nms_ious, monkeypatch):
    """Both CLIs with ``--fusion_method late`` on two synthetic scenes: the
    same results line and eval yaml; the port's NMS IoUs clear the
    threshold by NMS_MARGIN."""
    jax_dir, port_dir = late_dirs
    argv = ["--num_scenes", "2", "--seed", "5", "--fusion_method", "late"]
    monkeypatch.setattr(sys, "argv", ["prog", "--model_dir", jax_dir] + argv)
    jax_inference.main()
    got = inference.main(["--model_dir", port_dir, "--device", "cpu"] + argv)
    assert nms_ious
    for iou in nms_ious:
        assert np.abs(iou - 0.15).min() > NMS_MARGIN
    lines = [open(os.path.join(d, "results.txt")).read().splitlines()[-1]
             for d in late_dirs]
    assert lines[0] == lines[1]
    want = jax_load_yaml(os.path.join(jax_dir, "eval_epoch1.yaml"))
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-6), k
    assert got["ap_30"] > 0 and 0 < got["comm_rate"] < 1


def test_late_batch_replicates_each_agent():
    batch = {"points": torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(1, 2, 3, 4),
             "points_mask": torch.ones(1, 2, 3, dtype=torch.bool),
             "agent_mask": torch.tensor([[True, False]]),
             "pairwise_t": torch.rand(1, 2, 4, 4)}
    out = inference.late_batch(batch)
    assert torch.equal(out["points"][1], batch["points"][0])
    assert out["agent_mask"].tolist() == [[True, False], [False, False]]
    assert torch.equal(out["pairwise_t_full"][1, 0, 1], torch.eye(4))
    assert out["pairwise_t"].shape == (2, 2, 4, 4)


# ---------------------------------------------------------------------------
# the shipped YAMLs
# ---------------------------------------------------------------------------

YAMLS = ["opv2v/opv2v_disconet.yaml", "opv2v/opv2v_how2comm.yaml",
         "opv2v/opv2v_coalign.yaml", "opv2v/opv2v_late.yaml",
         "dair-v2x/dair_disconet.yaml", "dair-v2x/dair_how2comm.yaml",
         "dair-v2x/dair_coalign.yaml"]


def _abstract_batch(hypes):
    l = int(hypes["model"]["args"]["max_cav"])
    t = 2 if "how2comm" in hypes["model"]["core_method"] else 0
    lead = (1, t) if t else (1,)

    def s(shape, dtype=jnp.float32):
        return jax.ShapeDtypeStruct(shape, dtype)

    return {"points": s(lead + (l, 64, 4)),
            "points_mask": s(lead + (l, 64), jnp.bool_),
            "agent_mask": s(lead + (l,), jnp.bool_),
            "pairwise_t": s((1, l, 4, 4)),
            "pairwise_t_full": s(lead + (l, l, 4, 4)),
            "prior_encoding": s((1, l, 3))}


def test_registry_has_33_names():
    # the 33 names of the AirV2X, OPV2V and DAIR families, and the 23 of
    # V2X-R (tests/test_torch_v2xr_models.py; RTNH's and MDD's two each)
    assert len(MODEL_REGISTRY) == 33 + 23
    assert {"point_pillar_disconet", "point_pillar_how2comm",
            "point_pillar_coalign"} <= set(MODEL_REGISTRY)


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_and_bridges_at_full_width(path):
    full = os.path.join(REPO, "hypes_yaml", path)
    jh, th = jax_load_yaml(full), load_yaml(full)
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
    assert model.fast_pillars
    if core == "point_pillar_disconet":
        assert model.pixel_weight.conv0.weight.shape == (128, 512, 1, 1)
    elif core == "point_pillar_how2comm":
        assert len(model.fuse_modules) == 3
        assert model.channel_fuse.weight.shape == (64, 64, 7, 7)
        assert model.flow.pre_encoder.conv1_2.weight.shape == (32, 64, 3, 3)
    elif core == "point_pillar_coalign":
        assert [len(s.blocks) for s in model.backbone.stages] == [3, 5, 8]
        assert model.shrink_conv is None and model.head_in == 384

