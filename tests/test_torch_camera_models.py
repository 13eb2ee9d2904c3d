"""The camera compositions of the PyTorch port against the JAX package, on
the CPU: ``lift_splat_shoot_airv2x`` (det and seg, f32 and bf16) and every
model that an AirV2X camera config names besides the Where2comm det of
tests/test_torch_camera.py (``chip_smoke.py:TINY_COMPOSITIONS``: Where2comm
seg, V2X-ViT det and seg, CoBEVT det and seg, When2com det and seg, V2VNet
seg), each at the tiny config with every agent type camera only, the port
in both conv modes (``auto``: cuDNN; ``pallas``: K4's plain version, the BN
folded) against the JAX model in ``auto``, with equal det keep sets.

The models share one camera encoder's flax variables. The JAX encoder runs
once per compute dtype (its EfficientNet trunks take most of a JAX trace);
each JAX model then runs from that encoder output on, its encoder call
intercepted (``flax.linen.intercept_methods``), and the port runs the whole
model on the same variables. The LSS model's encoder output is the hetero
encoder's ego slot. The rest of each model's variables come from its tiny
LiDAR twin, whose backbone input width (16) the camera encoder shares.

The scenes are ``chip_smoke.py:tiny_camera_scene``: tests/test_torch_camera.py's
(seed 3: every frustum point more than CELL_MARGIN of a cell from a
boundary) with perturbed poses (``perturb_poses``), so the warps of
V2X-ViT, V2VNet and When2com move features. The JAX V2VNet fusion and the bf16 When2com fusion run eagerly
between the jitted spine and heads, as in tests/test_torch_intermediate.py
(XLA's CPU compiler miscompiles them).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import HeteroLidarEncoder as JaxHeteroEncoder
from airv2x_tpu.models.camera.lss import LSSCameraEncoder as JaxLSSEncoder
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.lss_model import LiftSplatShoot
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import cast_weights_, load_flax_variables
from tests.test_torch_camera import BF16_TOL, CELL_MARGIN, _frustum_margin
from tests.test_torch_intermediate import _keep_sets, _roi_margin
from tests.torch_port_helpers import (
    CHIP_SMOKE, TINY, one_torch_thread, random_variables)

TOL_MODEL = CHIP_SMOKE.TINY_TOL  # whole tiny models, x (1 + scale)
MARGIN = 1e-4  # ROI samples from 0.5, IoUs from the NMS threshold
TOP_K = 256
COMPOSITIONS = CHIP_SMOKE.TINY_COMPOSITIONS
LSS = "lift_splat_shoot_airv2x"
ENCODER_SEED = 30  # the shared camera encoder's variables
# the rest of each model's variables: seed 31 (32 for seg), or the first
# from there up whose decoded IoUs lie more than MARGIN from the NMS
# threshold in both conv modes
VAR_SEED = 31
VAR_SEEDS = {("airv2x_v2xvit", "det"): 41, ("airv2x_cobevt", "det"): 33,
             ("airv2x_when2com", "det"): 34, (LSS, "det"): 34}
EAGER = {("airv2x_v2vnet", "f32"), ("airv2x_v2vnet", "bf16"),
         ("airv2x_when2com", "bf16")}


def _hypes(load, name, task):
    return CHIP_SMOKE.tiny_composition_hypes(load(TINY), name, task)


def _lidar_twin(hypes):
    """The tiny LiDAR config of a camera composition (the same model)."""
    lidar = jax_load_yaml(TINY)
    out = copy.deepcopy(hypes)
    for t in ("vehicle", "rsu", "drone"):
        out["model"]["args"][t] = copy.deepcopy(lidar["model"]["args"][t])
    return out


def _intercepting(encoder_out):
    """An interceptor that answers the camera encoder's call with
    ``encoder_out``: the hetero encoder's (B, L, ny, nx, C), or its ego slot
    for the LSS model's encoder."""
    def icpt(next_fun, args, kwargs, context):
        if context.method_name == "__call__":
            if isinstance(context.module, JaxHeteroEncoder):
                return encoder_out
            if isinstance(context.module, JaxLSSEncoder):
                return encoder_out[:, 0]
        return next_fun(*args, **kwargs)
    return icpt


def _spine(m, b):
    """The flax PostBackboneFusionModel up to its fusion."""
    x = m.encoder(b, False)
    n, l = x.shape[:2]
    feats, _ = m.backbone(x.reshape((n * l,) + x.shape[2:]), False)
    feats = m.shrink_conv(feats, False)
    return feats.reshape((n, l) + feats.shape[1:])


def _tail(m, fused):
    out = dict(m.heads(fused) if m.task == "det" else m.seg_head(fused))
    out["comm_rate"] = jnp.asarray(1.0)
    return out


@pytest.fixture(scope="module")
def camera_world():
    """The two scenes, the shared encoder's variables and its JAX outputs per
    dtype, and per (name, task, dtype) the model's variables and JAX
    outputs (``auto``), on demand."""
    base = _hypes(jax_load_yaml, "airv2x_where2comm", "det")
    batch = CHIP_SMOKE.tiny_camera_scene(base)
    jb = jnp_tree_nested(batch)
    enc_model = jax_build_model(base)
    enc_var = random_variables(enc_model, jb, seed=ENCODER_SEED, train=False)
    enc_var = {c: {"encoder": enc_var[c]["encoder"]} for c in enc_var}
    encoded, variables, outs = {}, {}, {}

    def encoder_out(dtype):
        if dtype not in encoded:
            h = copy.deepcopy(base)
            if dtype == "bf16":
                h["model"]["args"]["dtype"] = "bf16"
            m = jax_build_model(h)
            encoded[dtype] = jax.jit(lambda v, b: m.apply(
                v, b, method=lambda mm, bb: mm.encoder(bb, False)))(enc_var, jb)
        return encoded[dtype]

    def model_var(name, task):
        seed = VAR_SEEDS.get((name, task), VAR_SEED + (task == "seg"))
        if (name, task, seed) not in variables:
            hypes = _hypes(jax_load_yaml, name, task)
            if name == LSS:  # the Where2comm twin's backbone, shrink, heads
                twin = _hypes(jax_load_yaml, "airv2x_where2comm", task)
            else:
                twin = hypes
            twin = _lidar_twin(twin)
            var = random_variables(jax_build_model(twin), jb, seed=seed,
                                   train=False)
            if name == LSS:
                head = "heads" if task == "det" else "seg_head"
                var = {c: {k: var[c][k] for k in ("backbone", "shrink_conv", head)
                           if k in var[c]} for c in var}
                for c in var:
                    var[c]["lss_encoder"] = enc_var[c]["encoder"]["vehicle_lss"]
            else:
                for c in var:
                    var[c]["encoder"] = enc_var[c]["encoder"]
            variables[name, task, seed] = var
        return variables[name, task, seed]

    def jax_out(name, task, dtype="f32"):
        key = (name, task, dtype)
        if key not in outs:
            hypes = _hypes(jax_load_yaml, name, task)
            if dtype == "bf16":
                hypes["model"]["args"]["dtype"] = "bf16"
            var = model_var(name, task)
            x = encoder_out(dtype)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("AIRV2X_CONV_KERNEL", "auto")  # read at trace time
                m = jax_build_model(hypes)
                with fnn.intercept_methods(_intercepting(x)):
                    if (name, dtype) not in EAGER:
                        out = jax.jit(lambda v, b: m.apply(v, b, train=False))(
                            var, jb)
                    else:
                        grouped = jax.jit(lambda v, b: m.apply(
                            v, b, method=_spine))(var, jb)
                        fused, _ = m.apply(var, grouped, jb, False, method=lambda
                                           mm, g, bb, t: mm.fuse(g, bb, t))
                        out = jax.jit(lambda v, f: m.apply(
                            v, f, method=_tail))(var, fused)
            outs[key] = {k: np.asarray(v, np.float32) for k, v in out.items()}
        return outs[key]

    return batch, model_var, jax_out


def jnp_tree_nested(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch_model(name, task, var, dtype=None):
    model = build_model(_hypes(load_yaml, name, task), device="cpu")
    load_flax_variables(model, var)
    if dtype is not None:
        cast_weights_(model, dtype)
    return model


def _close(got, want, tol, what):
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * (1 + scale), f"{what}: {err:.3e} (scale {scale:.3e})"


def test_scenes_clear_the_margins(camera_world):
    """Every frustum point more than CELL_MARGIN of a cell from a boundary;
    the V2X-ViT and V2VNet ROI samples more than MARGIN from 0.5; an absent
    agent and moved poses."""
    batch, _, _ = camera_world
    hypes = _hypes(load_yaml, "airv2x_where2comm", "det")
    assert _frustum_margin(hypes, batch) > CELL_MARGIN
    assert not batch["agent_mask"].all()
    assert np.abs(batch["pairwise_t"] - np.eye(4)).max() > 0.05
    sttf = CHIP_SMOKE.TINY_V2XVIT_ENCODER["sttf"]
    margins = {
        "v2xvit": float((CHIP_SMOKE.roi_samples(
            _hypes(load_yaml, "airv2x_v2xvit", "det"),
            torch.from_numpy(batch["pairwise_t"]), (48, 48)) - 0.5).abs().min()),
        "v2vnet": _roi_margin(batch["pairwise_t_full"], (48, 48),
                              sttf["voxel_size"][0],
                              CHIP_SMOKE.TINY_FAMILY["airv2x_v2vnet"][
                                  "v2vfusion"]["downsample_rate"])}
    assert min(margins.values()) > MARGIN, margins


def test_registry_knows_lss():
    assert MODEL_REGISTRY["lift_splat_shoot_airv2x"] is LiftSplatShoot
    assert MODEL_REGISTRY["lift_splat_shoot"] is LiftSplatShoot


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("name,task", COMPOSITIONS,
                         ids=[f"{n}-{t}" for n, t in COMPOSITIONS])
def test_tiny_composition_matches_jax(camera_world, monkeypatch, name, task,
                                      mode):
    """The whole model on the camera scenes, f32, to TINY_TOL x (1 + scale)
    of JAX's outputs; det keep sets equal, away from the NMS threshold."""
    batch, model_var, jax_out = camera_world
    want = jax_out(name, task)
    tmodel = _torch_model(name, task, model_var(name, task))
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    keys = ("psm", "rm", "obj") if task == "det" else ("dynamic_seg", "static_seg")
    assert set(got) == set(keys) | {"comm_rate"}
    for k in keys:
        assert got[k].shape == want[k].shape, k
        _close(got[k].numpy(), want[k], TOL_MODEL, f"{name} {task} {mode} {k}")
    assert float(got["comm_rate"]) == pytest.approx(float(want["comm_rate"]),
                                                    abs=1e-6)
    if task == "det":
        hypes = _hypes(load_yaml, name, task)
        for b in range(2):
            keep = _keep_sets(hypes, want, got, b)
            np.testing.assert_array_equal(keep["torch"], keep["jax"])
            assert 0 < keep["jax"].sum() < TOP_K


@pytest.mark.parametrize("task", ["det", "seg"])
def test_lss_bf16_matches_jax_bf16(camera_world, task):
    """The serving LSS model cast to bf16 against the JAX package computing
    in bf16 over f32 parameters, within tests/test_torch_camera.py's
    BF16_TOL, and no further from the exact (f32) outputs than 1.5 times
    JAX's own bf16."""
    batch, model_var, jax_out = camera_world
    want, exact = jax_out(LSS, task, "bf16"), jax_out(LSS, task)
    tmodel = _torch_model(LSS, task, model_var(LSS, task), torch.bfloat16)
    with torch.no_grad():
        got = tmodel(batch_to_torch(batch, "cpu"))
    keys = ("psm", "rm", "obj") if task == "det" else ("dynamic_seg", "static_seg")
    for k in keys:
        g = got[k].float().numpy()
        scale = float(np.abs(want[k]).max())
        err = float(np.abs(g - want[k]).max())
        assert err <= BF16_TOL * (1 + scale), (task, k, err, scale)
        own = float(np.abs(g - exact[k]).max())
        ref = float(np.abs(want[k] - exact[k]).max())
        assert own <= 1.5 * ref, (task, k, own, ref)


def test_lss_reads_the_ego_slot_only(camera_world):
    """Moving every other slot's images leaves the LSS outputs as they are,
    moving slot 0's moves them; comm_rate is 0 and the stages compose."""
    batch, model_var, _ = camera_world
    tmodel = _torch_model(LSS, "det", model_var(LSS, "det"))
    tb = batch_to_torch(batch, "cpu")
    other = copy.deepcopy(batch)
    other["cam_vehicle"]["imgs"][:, 1:] += 1.0
    other["cam_rsu"]["imgs"] += 1.0
    ego = copy.deepcopy(batch)
    ego["cam_vehicle"]["imgs"][:, 0] += 1.0
    with torch.no_grad():
        base = tmodel(tb)
        staged = tmodel.heads(tmodel.backbone(tmodel.encode(tb)))
        moved = tmodel(batch_to_torch(other, "cpu"))
        moved_ego = tmodel(batch_to_torch(ego, "cpu"))
    assert float(base["comm_rate"]) == 0.0
    for k in ("psm", "rm", "obj"):
        torch.testing.assert_close(staged[k], base[k], rtol=0, atol=0)
        torch.testing.assert_close(moved[k], base[k], rtol=0, atol=0)
    assert float((moved_ego["psm"] - base["psm"]).abs().max()) > 1e-3
