"""The tiny SCOPE model (``point_pillar_scope``) of the PyTorch port against
the JAX package, end to end: f32 on both backbones and in the three
aggregation modes, its kept detections after ``decode_detections``, bf16
against JAX bf16, the stage methods, and ``chip_smoke.scope_ops`` against
the operations the model executes.

The scene is ``chip_smoke.tiny_scope_batch``: two (or three) distinct
``make_scene`` frames of three slots (one absent), the earlier frames'
``history_t`` and the ego row of ``pairwise_t_full`` a few degrees and
metres off the identity, so the history warp and the collaboration's warp
both move features. The comm threshold, the query cut (the K-th against the
(K+1)-th score) and the NMS threshold each keep a stated margin, which the
tests assert: a value within it could decide the two packages apart."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.data.postprocess import decode_detections as jax_decode
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.data.postprocess import decode_detections
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.models.scope_model import PointPillarScope
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.ops.quad_iou import quad_iou_plain
from airv2x_tpu_torch.utils.weights import (
    cast_weights_, init_random_, load_flax_variables)
from tests.torch_port_helpers import (
    CHIP_SMOKE, assert_close, jnp_tree, one_torch_thread, random_variables)



TOL_MODEL = 1e-4  # whole-model outputs, f32, x (1 + scale)
MARGIN = 1e-4  # comm threshold, query cut and NMS threshold
TOP_K = 256
# bf16 whole-model eval against JAX bf16, x (1 + scale). Measured on the
# tiny ResNet model (variables seed VAR_SEED): the port's bf16 psm / rm lie
# 0.047 / 0.073 x (1 + scale) from JAX bf16, and 0.99x as far from the f32
# outputs as JAX's own bf16 (seeds 0-13: 0.010-0.179 x (1 + scale), 0.47-
# 1.64x): both sides' bf16 rounding through the backbone, the LSTM's eight
# pyramids and the deformable attention. The bound leaves twice the room.
BF16_TOL = 0.15
# variables seed 5: the first from 0 up whose comm, query and NMS margins
# all exceed MARGIN on both backbones
VAR_SEED = 5
OUT_KEYS = ("psm", "rm", "psm_single_v", "rm_single_v", "psm_single_i",
            "rm_single_i")


@pytest.fixture(scope="module")
def runs():
    """Per (backbone, mode, dtype): the JAX outputs on the batch, the
    variables (one tree per backbone) and the hypes, on demand."""
    cache, variables = {}, {}

    def get(resnet=True, mode="Deform", dtype="float32", frames=2):
        key = (resnet, mode, dtype, frames)
        if key not in cache:
            hypes = CHIP_SMOKE.tiny_scope_hypes(resnet, mode)
            batch = CHIP_SMOKE.tiny_scope_batch(hypes, frames)
            jhypes = copy.deepcopy(hypes)
            jhypes["model"]["args"]["dtype"] = dtype
            jmodel = jax_build_model(jhypes)
            vkey = (resnet, mode)
            if vkey not in variables:
                variables[vkey] = random_variables(
                    jax_build_model(hypes), jnp_tree(batch), seed=VAR_SEED,
                    train=False)
            out = jax.jit(lambda v, b: jmodel.apply(v, b, train=False))(
                variables[vkey], jnp_tree(batch))
            cache[key] = (hypes, batch, variables[vkey],
                          {k: np.asarray(v, np.float32) for k, v in out.items()})
        return cache[key]

    return get


def _torch_model(hypes, var, dtype=None):
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    return cast_weights_(model, dtype) if dtype is not None else model


@pytest.mark.parametrize("resnet,frames", [(True, 2), (False, 2), (True, 3)],
                         ids=["resnet", "plain", "resnet-3-frames"])
def test_tiny_scope_matches_jax(runs, resnet, frames):
    hypes, batch, var, want = runs(resnet, frames=frames)
    model = _torch_model(hypes, var)
    assert isinstance(model, PointPillarScope)
    kernels.reset_launch_counts()
    margins, _, got = CHIP_SMOKE.scope_margins(model, batch_to_torch(batch, "cpu"))
    assert kernels.LAUNCHES["pillar_encode"] == 0  # the CPU's plain version
    assert margins["comm"] > MARGIN and margins["topk"] > MARGIN, margins
    assert set(got) == set(want)
    for k in OUT_KEYS:
        assert got[k].shape == want[k].shape
        assert np.abs(want[k]).max() > 0
        assert_close(got[k].numpy(), want[k], TOL_MODEL, TOL_MODEL, k)
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0


@pytest.mark.parametrize("mode", ["MAX", "ATTEN"])
def test_tiny_scope_other_modes_match_jax(runs, mode):
    hypes, batch, var, want = runs(True, mode)
    assert not any(k.startswith("deform_fuse") for k in var["params"])
    with torch.no_grad():
        got = _torch_model(hypes, var)(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm"):
        assert_close(got[k].numpy(), want[k], TOL_MODEL, TOL_MODEL, k)


def _keep(out, hypes, b, decode, anchors, eye, lr, jax_side):
    """The keep set per anchor of sample ``b``: psm is the score (the binary
    family has no objectness head)."""
    kw = dict(num_class=1,
              obj_threshold=hypes["postprocess"]["target_args"]["obj_threshold"],
              nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=TOP_K)
    psm, rm = out["psm"][b], out["rm"][b]
    det = decode(psm, rm, psm, anchors, eye, lr, **kw)
    keep = np.zeros(anchors.shape[0] * anchors.shape[1] * anchors.shape[2], bool)
    if jax_side:
        objness = jax.nn.sigmoid(psm).reshape(-1)
        gated = jnp.where(objness > kw["obj_threshold"], objness, -jnp.inf)
        keep[np.asarray(jax.lax.top_k(gated, 2 * TOP_K)[1])] = det.mask
    else:
        objness = torch.sigmoid(psm).reshape(-1)
        gated = torch.where(objness > kw["obj_threshold"], objness, -torch.inf)
        idx = torch.sort(gated, descending=True, stable=True)[1][:2 * TOP_K]
        keep[idx.numpy()] = det.mask.numpy()
    return keep, det


@pytest.mark.parametrize("resnet", [True, False], ids=["resnet", "plain"])
def test_tiny_scope_keep_sets_match_jax(runs, resnet):
    hypes, batch, var, want = runs(resnet)
    with torch.no_grad():
        got = _torch_model(hypes, var)(batch_to_torch(batch, "cpu"))
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    assert anchors.shape == (32, 32, 2, 7)
    lr = np.asarray(hypes["preprocess"]["cav_lidar_range"], np.float32)
    jkeep, _ = _keep({k: jnp.asarray(v) for k, v in want.items()}, hypes, 0,
                     jax_decode, jnp.asarray(anchors), jnp.eye(4),
                     jnp.asarray(lr), True)
    tkeep, tdet = _keep(got, hypes, 0, decode_detections,
                        torch.from_numpy(anchors), torch.eye(4),
                        torch.from_numpy(lr), False)
    live = tdet.corners[:, :4, :2].contiguous()
    iou = quad_iou_plain(live, live).numpy()
    gap = np.abs(iou[np.triu_indices(len(iou), k=1)] - 0.15).min()
    assert gap > MARGIN, f"an IoU lies {gap:.2e} from the NMS threshold"
    np.testing.assert_array_equal(tkeep, jkeep)
    assert 0 < jkeep.sum() < TOP_K


def test_tiny_scope_bf16_matches_jax_bf16(runs):
    """The serving model cast to bf16 (its LSTM biases and initial cell
    state stay f32) against JAX computing in bf16 over f32 parameters:
    within BF16_TOL, and no further from the f32 outputs than JAX's own
    bf16 lies from them, with 50% room."""
    hypes, batch, var, want = runs(True, dtype="bf16")
    exact = runs(True)[3]
    model = _torch_model(hypes, var, torch.bfloat16)
    with torch.no_grad():
        got = model(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "psm_single_v"):
        assert got[k].dtype == torch.bfloat16
        g = got[k].float().numpy()
        scale = np.abs(want[k]).max()
        assert scale > 1
        assert np.abs(g - want[k]).max() <= BF16_TOL * (1 + scale), k
        own, ref = np.abs(g - exact[k]).max(), np.abs(want[k] - exact[k]).max()
        assert own <= 1.5 * ref, (k, own, ref)


def test_tiny_scope_stages_compose(runs):
    """``forward`` marks its four stages in order; the stage methods run by
    hand give the same outputs."""
    hypes, batch, var, _ = runs(True)
    model = _torch_model(hypes, var)
    tb = batch_to_torch(batch, "cpu")
    marks = []
    with torch.no_grad():
        whole = model(tb, marks.append)
        frames = model.frame_features(tb)
        temporal, psm_t = model.temporal(frames, tb)
        staged = model.late_heads(temporal, psm_t, frames[-1][1],
                                  model.collaborate(frames, tb))
    assert tuple(marks) == PointPillarScope.STAGES
    assert len(frames) == 2 and frames[0][1].shape == (1, 3, 32, 32, 32)
    assert temporal.shape == (1, 32, 32, 32)
    for k in OUT_KEYS:
        torch.testing.assert_close(staged[k], whole[k], rtol=0, atol=0)


def test_scope_scene_bench_and_perturbed():
    """Without ``pose_rng`` the bench's ``temporal_det`` scene: one frame
    repeated, identity history; with it, distinct frames and poses."""
    hypes = CHIP_SMOKE.tiny_scope_hypes()
    layout = SlotLayout.from_args(hypes["model"]["args"])
    bench = CHIP_SMOKE.scope_scene(np.random.default_rng(0), layout, 2,
                                   hypes["preprocess"]["cav_lidar_range"],
                                   points_per_agent=256, pts_per_box=10)
    assert bench["points"].shape == (1, 2, 3, 256, 4)
    np.testing.assert_array_equal(bench["points"][:, 0], bench["points"][:, 1])
    np.testing.assert_array_equal(bench["history_t"][0], np.stack([np.eye(4)] * 2))
    pert = CHIP_SMOKE.tiny_scope_batch(hypes)
    assert np.abs(pert["points"][:, 0] - pert["points"][:, 1]).max() > 1
    assert np.abs(pert["history_t"][0, 0] - np.eye(4)).max() > 0.01
    np.testing.assert_array_equal(pert["history_t"][0, 1], np.eye(4))
    ego_row = pert["pairwise_t_full"][0, :, 0]
    np.testing.assert_array_equal(ego_row[:, 0], np.stack([np.eye(4)] * 2))
    assert np.abs(ego_row[:, 1:] - np.eye(4)).max() > 0.01


def test_scope_ops_match_the_executed_convolutions_and_linears():
    """``chip_smoke.scope_ops`` (phase 12's count, from the configuration's
    shapes) equals, by part, what forward hooks count on a run of the tiny
    model on both backbones: a conv's output elements x its input channels
    x its taps, a transposed conv's input elements x its output channels x
    its taps, a Linear's outputs x its inputs, two operations each."""
    parts_of = (("vfe", "pillar PFN"), ("temporal_fusion", "temporal LSTM"),
                ("fuse_modules", "deformable attention"),
                ("backbone", "backbone"), ("shrink_conv", "shrink"))
    for resnet in (True, False):
        hypes = CHIP_SMOKE.tiny_scope_hypes(resnet)
        model = init_random_(build_model(hypes, device="cpu"), seed=3)
        tb = batch_to_torch(CHIP_SMOKE.tiny_scope_batch(hypes), "cpu")
        counted = {}

        def hook(name):
            part = next((p for pre, p in parts_of if name.startswith(pre)),
                        "heads")

            def count(mod, args, out):
                k = mod.weight[0, 0].numel() if not isinstance(
                    mod, torch.nn.Linear) else 1
                if isinstance(mod, torch.nn.ConvTranspose2d):
                    ops = 2 * args[0].numel() * mod.out_channels * k
                elif isinstance(mod, torch.nn.Conv2d):
                    ops = 2 * out.numel() * mod.in_channels // mod.groups * k
                else:
                    ops = 2 * out.numel() * mod.in_features
                counted[part] = counted.get(part, 0) + ops
            return count

        handles = [m.register_forward_hook(hook(n))
                   for n, m in model.named_modules()
                   if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d,
                                     torch.nn.Linear))]
        try:
            with torch.inference_mode():
                model(tb)
        finally:
            for h in handles:
                h.remove()
        assert CHIP_SMOKE.scope_ops(hypes, tb["points"].shape[-2]) == counted


def test_scope_builds_on_the_card_unless_asked_for_the_cpu():
    """``build_model`` defaults to the card (and raises without one); on the
    CPU when asked; with ``train`` a trainable model in train mode (its
    train step is held to JAX's in tests/test_torch_opv2v_data.py)."""
    hypes = CHIP_SMOKE.tiny_scope_hypes()
    assert isinstance(build_model(hypes, device="cpu"), PointPillarScope)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(hypes)
    model = build_model(hypes, device="cpu", train=True)
    assert all(m.training for m in model.modules())
    assert all(p.requires_grad for p in model.parameters())
