"""The tiny HEAL, STAMP and SiCP models of the PyTorch port against the JAX
package on the CPU: det and seg, f32, through the weight bridge (SiCP also
in ``pallas`` conv mode), with their keep sets; HEAL with
``cam_crop_ratios``; bf16 against JAX bf16; the stage methods; the serving
cast and the initialisers on the new leaves; a config with ``alignnet``
refused.

The tiny configs are ``chip_smoke.py:TINY_HETERO`` over the tiny config
(tests/test_model_zoo.py's variants). The two scenes have perturbed poses
(an absent drone in the second), so every warp moves features; the tests
assert that each warp decides its footprint's edge more than MARGIN pixels
from it, and that no decoded IoU lies within MARGIN of the NMS threshold.

XLA's CPU jit (jax 0.9.0) miscompiles the JAX ``weighted_fuse`` (ROADMAP
§3): the jitted tiny HEAL det model lies 7.55 off its eager psm (scale
41.5), which the port reads to 2.4e-5. The JAX HEAL and STAMP models are
compiled without LLVM's optimisations (``XLA_OPT0``), where they read the
eager values.
"""

import jax
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch, perturb_poses
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.fusion.adapter import ConvNeXtBlock, DSALayer
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import (
    cast_weights_, init_flax_like_, init_random_, load_flax_variables)
from tests.test_torch_intermediate import _keep_sets
from tests.torch_port_helpers import (
    CHIP_SMOKE, TINY, assert_close, jnp_tree, one_torch_thread,
    random_variables)
from tests.torch_train_helpers import XLA_OPT0

NAMES = ("airv2x_heal", "airv2x_stamp", "airv2x_sicp")
TOL = CHIP_SMOKE.TINY_TOL  # whole tiny models, x (1 + scale)
MARGIN = 1e-4
POSE_SEED = 2
# flax variables seed per name (seg: one more): the first from 5 up whose
# decoded boxes keep some in both scenes with no pair within MARGIN of the
# NMS threshold (seed 5: HEAL's 6.3e-5 from it, STAMP's second scene keeps
# none; SiCP's seeds 5-21 each miss one or the other)
VAR_SEED = {"airv2x_heal": 6, "airv2x_stamp": 6, "airv2x_sicp": 22}


def _close(got, want, what, tol=TOL):
    scale = np.abs(want).max()
    assert scale > 0, what
    assert_close(got, want, tol * (1 + scale), 0, what)


def _crop_ratios(batch):
    """(B, L, 2): the non-ego agents as cameras of ratio 2, the ego LiDAR."""
    r = np.zeros(batch["agent_mask"].shape + (2,), np.float32)
    r[:, 1:] = 2.0
    return r


@pytest.fixture(scope="module")
def hetero_run():
    """Two scenes of the tiny config (one with a drone, one without),
    perturbed poses; per (name, task, dtype, crop) JAX's outputs, on
    demand."""
    hypes = jax_load_yaml(TINY)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    rng = np.random.default_rng(0)
    scenes = [
        jax_make_scene(rng, layout, num_objects=6, points_per_agent=1024,
                       lidar_range=hypes["preprocess"]["cav_lidar_range"],
                       pts_per_box=60, num_agents=na)[0]
        for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
                   {"vehicle": 2, "rsu": 1, "drone": 0})]
    batch = {k: np.stack([s[k] for s in scenes]) for k in scenes[0]}
    perturb_poses(batch, np.random.default_rng(POSE_SEED))
    cache, variables = {}, {}

    def jax_out(name, task, dtype="f32", crop=False):
        if (name, task) not in variables:
            jh = CHIP_SMOKE.tiny_hetero_hypes(hypes, name, task)
            variables[name, task] = random_variables(
                jax_build_model(jh), jnp_tree(batch),
                seed=VAR_SEED[name] + (task == "seg"), train=False)
        key = (name, task, dtype, crop)
        if key not in cache:
            jh = CHIP_SMOKE.tiny_hetero_hypes(hypes, name, task)
            if dtype == "bf16":
                jh["model"]["args"]["dtype"] = "bf16"
            jm = jax_build_model(jh)
            b = dict(batch, cam_crop_ratios=_crop_ratios(batch)) if crop else batch
            fn = jax.jit(lambda v, bb: jm.apply(v, bb, train=False))
            args = (variables[name, task], jnp_tree(b))
            out = fn.lower(*args).compile(XLA_OPT0)(*args)
            cache[key] = {k: np.asarray(v, np.float32) for k, v in out.items()}
        return cache[key], variables[name, task]

    return batch, jax_out


def _port(name, var, task="det"):
    hypes = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), name, task)
    model = build_model(hypes, device="cpu")
    load_flax_variables(model, var)
    return hypes, model


def test_registry_has_the_three_names():
    assert set(NAMES) <= set(MODEL_REGISTRY)
    assert len(MODEL_REGISTRY) == 56  # with the five early / BM2CP names,
    # DiscoNet, How2comm, CoAlign, V2X-R's 19, RTNH's and MDD's two each


def test_tiny_scenes_exercise_the_warps(hetero_run):
    """Perturbed poses, an absent drone, and every warp of the three models
    decides its footprint's edge more than MARGIN pixels from it."""
    batch, jax_out = hetero_run
    assert not batch["agent_mask"].all()
    assert np.abs(batch["pairwise_t"][:, 1:] - np.eye(4)).max() > 0.05
    tb = batch_to_torch(batch, "cpu")
    for name in NAMES:
        _, model = _port(name, jax_out(name, "det")[1])
        margin = CHIP_SMOKE.hetero_footprint_margin(model, tb)
        assert margin > MARGIN, (name, margin)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_tiny_det_model_matches_jax(hetero_run, monkeypatch, name, mode):
    """psm / rm / obj of the f32 model and the keep sets of both scenes.
    HEAL's and STAMP's paths hold no ``ConvBNReLU`` (their ``pallas`` run
    is the ``auto`` one); SiCP's backbone runs the conv kernel's plain
    version in ``pallas``."""
    batch, jax_out = hetero_run
    want, var = jax_out(name, "det")
    hypes, model = _port(name, var)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    with torch.no_grad():
        got = model(batch_to_torch(batch, "cpu"))
    assert set(got) == set(want)
    for k in ("psm", "rm", "obj"):
        assert got[k].shape == want[k].shape and want[k].shape[:3] == (2, 48, 48)
        _close(got[k].numpy(), want[k], f"{name} {mode} {k}")
    assert float(got["comm_rate"]) == float(want["comm_rate"]) == 1.0
    for b in range(2):
        keep = _keep_sets(hypes, want, got, b)
        np.testing.assert_array_equal(keep["torch"], keep["jax"])
        assert 0 < keep["jax"].sum()


@pytest.mark.parametrize("name", NAMES)
def test_tiny_seg_model_matches_jax(hetero_run, name):
    batch, jax_out = hetero_run
    want, var = jax_out(name, "seg")
    _, model = _port(name, var, "seg")
    with torch.no_grad():
        got = model(batch_to_torch(batch, "cpu"))
    assert set(got) == {"dynamic_seg", "static_seg", "comm_rate"}
    for k in ("dynamic_seg", "static_seg"):
        assert got[k].shape == want[k].shape == (2, 96, 96, want[k].shape[-1])
        _close(got[k].numpy(), want[k], f"{name} seg {k}")


def test_heal_reads_cam_crop_ratios_as_jax(hetero_run):
    """HEAL with the optional ``cam_crop_ratios`` batch key (no dataset
    fills it): the port matches JAX, and the crop moves the outputs."""
    batch, jax_out = hetero_run
    want, var = jax_out("airv2x_heal", "det", crop=True)
    plain, _ = jax_out("airv2x_heal", "det")
    _, model = _port("airv2x_heal", var)
    tb = batch_to_torch(dict(batch, cam_crop_ratios=_crop_ratios(batch)), "cpu")
    with torch.no_grad():
        got = model(tb)
    for k in ("psm", "rm", "obj"):
        _close(got[k].numpy(), want[k], f"cam crop {k}")
    assert np.abs(want["psm"] - plain["psm"]).max() > 0.1


def test_tiny_stages_compose(hetero_run):
    """encode -> backbone -> fuse -> heads is ``forward`` (HEAL, SiCP)."""
    batch, jax_out = hetero_run
    tb = batch_to_torch(batch, "cpu")
    for name in ("airv2x_stamp", "airv2x_sicp"):
        _, model = _port(name, jax_out(name, "det")[1])
        with torch.no_grad():
            feats = model.backbone(model.encode(tb))
            staged = model.heads(model.fuse(feats, tb))
            whole = model(tb)
        for k in ("psm", "rm", "obj"):
            torch.testing.assert_close(staged[k], whole[k], rtol=0, atol=0)
    assert feats.shape == (2, 4, 64, 48, 48)


# bf16 whole-model eval against JAX bf16, x (1 + scale), the largest of
# psm / rm / obj over the two scenes (scene seed 0, poses seed 2, the
# VAR_SEED variables), measured: HEAL 0.0194, STAMP 0.0638, SiCP 0.0155;
# the port's bf16 lies 1.31 / 2.15 / 1.09 times as far from the f32
# outputs as JAX's own bf16 does. STAMP's is the largest with its adapter
# computed in f32 too (0.0625): its weights amplify both sides' rounding
# through the ~30 layers of the ResNeXt pyramid, where XLA keeps each fused
# elementwise chain (BN, ReLU, the residual) in f32 and the port rounds
# each op to bf16. BF16_TOL leaves 1.5x the largest; BF16_RATIO is
# tests/test_torch_intermediate.py's.
BF16_TOL = 0.1
BF16_RATIO = 2.5


@pytest.mark.parametrize("name", NAMES)
def test_tiny_det_bf16_matches_jax_bf16(hetero_run, name):
    """The serving model cast to bf16 (``cast_weights_``) against the JAX
    package computing in bf16: within BF16_TOL of it, and at most
    BF16_RATIO times as far from the f32 outputs as JAX's own bf16."""
    batch, jax_out = hetero_run
    (want, var), (exact, _) = (jax_out(name, "det", "bf16"),
                               jax_out(name, "det"))
    _, model = _port(name, var)
    cast_weights_(model, torch.bfloat16)
    with torch.no_grad():
        got = model(batch_to_torch(batch, "cpu"))
    for k in ("psm", "rm", "obj"):
        g = got[k].float().numpy()
        scale = np.abs(want[k]).max()
        err = np.abs(g - want[k]).max()
        assert err <= BF16_TOL * (1 + scale), (k, err, scale)
        own, ref = np.abs(g - exact[k]).max(), np.abs(want[k] - exact[k]).max()
        assert own <= BF16_RATIO * ref, (k, own, ref)


def _stamp_with(variant):
    """The tiny STAMP det model with every type's adapter ``variant``."""
    hypes = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), "airv2x_stamp")
    cfg = dict(CHIP_SMOKE.TINY_ADAPTER, core_method=variant)
    cfg["args"] = dict(cfg["args"], submodule_args={
        "dim": 16, "depth": 2, "n_layers": 1, "num_heads": 4, "num_points": 2})
    for t in ("vehicle", "rsu", "drone"):
        hypes["model"]["args"][t]["adapter"] = cfg
    return build_model(hypes, device="cpu")


def test_cast_weights_keeps_the_norms_f32():
    """Under the bf16 serving cast the ConvNeXt LayerNorms and every
    BatchNorm stay f32; the depthwise and grouped convs, the Linears and
    ``gamma`` go bf16."""
    model = cast_weights_(_stamp_with("adapterconvnext"), torch.bfloat16)
    block = model.adapter_vehicle.core.blocks[1]
    assert isinstance(block, ConvNeXtBlock)
    assert block.norm.weight.dtype == torch.float32
    for t in (block.dwconv.weight, block.fc1.weight, block.gamma,
              model.pyramid.resnet.stages[0].blocks[0].conv1.weight,
              model.pyramid.occ_heads[1].weight):
        assert t.dtype == torch.bfloat16
    bn = model.pyramid.resnet.stages[1].blocks[0].bn1
    assert bn.weight.dtype == bn.running_var.dtype == torch.float32


@pytest.mark.parametrize("init", [init_flax_like_, init_random_],
                         ids=["flax_like", "random"])
@pytest.mark.parametrize("variant", ["adapterconvnext", "adapterfc",
                                     "adapterdsa"])
def test_initialisers_cover_the_adapter_leaves(init, variant):
    """Both initialisers reach every adapter tensor (none keeps its NaN
    fill) and repeat from their seed; ``init_flax_like_`` gives flax's own
    rules: ``gamma`` 1e-6, the FC weights uniform within sqrt(6 / fan_in),
    the DSA offset and weight kernels 0 and the offsets' ring bias."""
    model = _stamp_with(variant)
    ad = model.adapter_rsu
    with torch.no_grad():
        for t in ad.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    init(model, seed=3)
    for k, t in ad.state_dict().items():
        assert not torch.isnan(t).any(), k
    again = init(_stamp_with(variant), seed=3)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k
    if init is not init_flax_like_:
        return
    core = ad.core
    if variant == "adapterconvnext":
        assert (core.blocks[0].gamma == 1e-6).all()
    elif variant == "adapterfc":
        bound = (6.0 / (48 * 48 * 16)) ** 0.5
        assert float(core.weights.abs().max()) <= bound
        assert float(core.weights.std()) > 0.5 * bound / 3 ** 0.5
        assert (core.biases == 0).all()
    else:
        layer = core.layers[0]
        assert isinstance(layer, DSALayer)
        assert (layer.offsets.weight == 0).all() and (layer.weights.weight == 0).all()
        ring = layer.offsets.bias.reshape(4, 2, 2)
        torch.testing.assert_close(ring[:, 1], 2 * ring[:, 0])
        assert float(core.rope_freqs.abs().max()) <= 1.0


def test_alignnet_config_is_refused():
    """HEAL builds the ``alignnet`` key's AlignNet (its parity tests are in
    tests/test_torch_alignnet.py); STAMP, as the JAX package's, reads no
    such key."""
    for name, built in (("airv2x_heal", True), ("airv2x_stamp", False)):
        hypes = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), name)
        hypes["model"]["args"]["alignnet"] = {"core_method": "convnext"}
        model = build_model(hypes, device="cpu")
        assert (model.alignnet is not None) == built, name
