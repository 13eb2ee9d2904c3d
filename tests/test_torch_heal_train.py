"""Training HEAL, STAMP and SiCP in the PyTorch port against the JAX
package on the CPU: one ``make_train_step`` update of each tiny det model
(SiCP's with the dual-head ``point_pillar_loss_sicp_multiclass``), SiCP's
train-mode heads, ``backbone_fix`` true and as a list of agent
types (the frozen set JAX's ``freeze_by_path`` labels, frozen parameters
bit-unchanged, every frozen module's BN statistics updated as flax's
``batch_stats`` are, the rest held to JAX's step), ``merge_compatible``'s
shape skip, and
the multi-stage recipe end to end through both CLIs on tiny configs.

XLA's CPU jit miscompiles the JAX HEAL and STAMP steps as it does their
forward (ROADMAP §3): the tiny HEAL det step's loss reads 947.523 jitted in
float64 and 946.889 without LLVM's optimisations (``XLA_OPT0``) in f32 and
float64, where the port's f32 step reads 946.889 (float64 at ``XLA_OPT0``
takes ~70 s per step). The references are JAX's f32 steps at ``XLA_OPT0``,
held at the step tolerances of tests/test_torch_train.py.
"""

import copy
import os

import jax
import numpy as np
import optax
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.parallel import train as jax_train
from airv2x_tpu_torch.config import load_yaml, save_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.parallel.train import backbone_fix_prefixes
from airv2x_tpu_torch.tools import inference_multi_scenario
from airv2x_tpu_torch.tools import train as train_cli
from airv2x_tpu_torch.tools import train_multi_stage
from airv2x_tpu_torch.utils.checkpoint import find_last_epoch
from airv2x_tpu_torch.utils.weights import flax_paths, load_flax_variables
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread
from tests.torch_train_helpers import (
    XLA_OPT0, check_gradients, check_loss_parts, check_params_and_stats,
    jax_step, labelled_batch, port_step, twin, variables_for)

# (model, task, loss): one step each; SiCP's with the dual-head loss, which
# supervises both its heads (the shipped loss reads the fused ones only)
CASES = {"heal-det": ("airv2x_heal", "det", None),
         "stamp-det": ("airv2x_stamp", "det", None),
         "sicp-det-dual": ("airv2x_sicp", "det", "point_pillar_loss_sicp_multiclass")}


def tiny_hypes(load, case, fix=None):
    name, task, loss = CASES[case]
    hypes = CHIP_SMOKE.tiny_hetero_hypes(load(TINY), name, task)
    if loss:
        hypes["loss"]["det"]["core_method"] = loss
    if fix is not None:
        hypes["model"]["args"]["backbone_fix"] = fix
    return hypes


@pytest.fixture(scope="module")
def batch():
    return labelled_batch()


@pytest.fixture(scope="module")
def jax_runs(batch):
    """Per case, its seeded flax variables and one JAX f32 step at
    ``XLA_OPT0`` from them (params, batch_stats, loss parts, gradients),
    made once for the step tests and the ``backbone_fix`` tests."""
    cache = {}

    def get(case):
        if case not in cache:
            jh = tiny_hypes(jax_load_yaml, case)
            var = variables_for(jh, batch)
            cache[case] = (var,) + jax_step(jh, batch, var,
                                            compiler_options=XLA_OPT0)
        return cache[case]

    return get


@pytest.fixture(scope="module", params=sorted(CASES))
def step_run(request, batch, jax_runs):
    th = tiny_hypes(load_yaml, request.param)
    var, params, stats, jparts, grads = jax_runs(request.param)
    model, parts = port_step(th, batch, var)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(th, grads, stats), after=twin(th, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"])


def test_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100) > 0


def test_sicp_dual_heads_in_train_mode(batch):
    """In train mode SiCP returns the ego map's heads (``...1``) and the
    fused map's (``...2`` and the plain names); in eval the fused map's."""
    model = build_model(tiny_hypes(load_yaml, "sicp-det-dual"), device="cpu",
                        train=True)
    tb = batch_to_torch({k: v for k, v in batch.items() if k != "labels"}, "cpu")
    with torch.no_grad():
        out = model(tb)
        plain = model.eval()(tb)
    assert set(out) == {"psm", "rm", "obj", "psm1", "rm1", "obj1", "psm2",
                        "rm2", "obj2", "comm_rate"}
    assert out["psm2"] is out["psm"]
    assert (out["psm1"] - out["psm2"]).abs().max() > 0
    assert set(plain) == {"psm", "rm", "obj", "comm_rate"}


# --- backbone_fix -----------------------------------------------------------------

FIXES = {"true": ("heal-det", True), "types": ("stamp-det", ["rsu", "drone"])}


@pytest.fixture(scope="module", params=sorted(FIXES))
def fix_run(request, batch, jax_runs):
    """One port step with ``backbone_fix`` patched in (``freeze_by_path``)
    from its case's variables, and JAX's step of that case with the leaves
    JAX's ``freeze_by_path`` freezes kept at their start values: Adam
    updates each parameter from its own gradient and the forward does not
    change, so that is JAX's frozen step; its loss and BN statistics are
    the unfrozen step's."""
    case, fix = FIXES[request.param]
    th = tiny_hypes(load_yaml, case, fix)
    prefixes = backbone_fix_prefixes(th["model"]["args"])
    assert prefixes == jax_train.backbone_fix_prefixes(
        tiny_hypes(jax_load_yaml, case, fix)["model"]["args"])
    var, params, stats, jparts, grads = jax_runs(case)
    frozen = _jax_frozen_leaves(var["params"], prefixes)
    start = dict(_flatten(var["params"]))
    after = _unflatten({k: start[k] if k in frozen else v
                        for k, v in _flatten(params)})
    model, parts = port_step(th, batch, var, freeze=prefixes)
    return dict(model=model, parts=parts, jparts=jparts, var=var,
                prefixes=prefixes, hypes=th, jfrozen=frozen,
                grads=twin(th, grads, stats), after=twin(th, after, stats))


def _jax_frozen_leaves(params, prefixes):
    """The leaves JAX's ``freeze_by_path`` gives no update: an SGD step of
    unit gradients through it moves every other leaf."""
    tx = jax_train.freeze_by_path(optax.sgd(1.0), params, prefixes)
    ones = jax.tree.map(np.ones_like, params)
    updates, _ = tx.update(ones, tx.init(params), params)
    return {k for k, u in _flatten(updates) if not np.any(np.asarray(u))}


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def test_backbone_fix_freezes_the_leaves_jax_freezes(fix_run):
    """The port's frozen parameters are the flax leaves JAX labels frozen,
    through the bridge's name map; some are frozen, some train."""
    model = fix_run["model"]
    paths = flax_paths(model)
    frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert {paths[n][1:] for n in frozen} == fix_run["jfrozen"]
    assert 0 < len(frozen) < len(list(model.parameters()))
    if fix_run["prefixes"] == ["rsu_pillar_vfe", "drone_pillar_vfe"]:
        assert all(n.startswith(("encoder.rsu_", "encoder.drone_")) for n in frozen)
    else:
        assert any(n.startswith("det_heads.") for n in frozen)
        assert not any(n.startswith("pyramid.") for n in frozen)


def test_backbone_fix_leaves_frozen_parameters_bit_unchanged(fix_run):
    """No update and no weight decay on a frozen parameter; the trainable
    ones, the loss and the BN statistics held to JAX's frozen step."""
    model, var = fix_run["model"], fix_run["var"]
    start = build_model(fix_run["hypes"], device="cpu")
    load_flax_variables(start, var)
    before = dict(start.named_parameters())
    after = dict(fix_run["after"].named_parameters())
    moved = 0
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p, before[n]), n
        else:
            moved += int(not torch.equal(p, before[n]))
    assert moved > 0
    check_loss_parts(fix_run["parts"], fix_run["jparts"])
    check_params_and_stats(model, fix_run["after"], fix_run["grads"],
                           min_clear=100)


def test_backbone_fix_still_updates_frozen_bn_statistics(fix_run):
    """A frozen module's BN running statistics move in train mode (as
    flax's ``batch_stats``, which the optimizer does not own), to JAX's."""
    model, var = fix_run["model"], fix_run["var"]
    start = build_model(fix_run["hypes"], device="cpu")
    load_flax_variables(start, var)
    before = dict(start.named_buffers())
    paths = flax_paths(model)
    frozen_scopes = {paths[n][1:-1] for n, p in model.named_parameters()
                     if not p.requires_grad}
    moved = 0
    for n, b in model.named_buffers():
        if n.endswith("running_mean") and paths[n][1:-1] in frozen_scopes:
            assert not torch.equal(b, before[n]), n
            moved += 1
    assert moved > 0


# --- merge_compatible and the multi-stage CLI -----------------------------------

def test_merge_compatible_skips_shape_mismatches():
    """Tensors whose name and shape match are copied; a shape mismatch
    (an adapter of another width) and a name the source lacks keep the
    target's values."""
    src_h = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), "airv2x_stamp")
    src_h["model"]["args"]["vehicle"]["adapter"]["args"]["submodule_args"][
        "dim"] = 8
    dst_h = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), "airv2x_stamp")
    dst_h["model"]["args"]["vehicle"]["adapter"]["args"]["submodule_args"][
        "depth"] = 2
    src = build_model(src_h, device="cpu")
    dst = build_model(dst_h, device="cpu")
    torch.manual_seed(0)
    with torch.no_grad():
        for p in list(src.parameters()) + list(dst.parameters()):
            p.normal_()
    keep = {k: v.clone() for k, v in dst.state_dict().items()}
    copied = train_multi_stage.merge_compatible(dst.state_dict(),
                                                src.state_dict())
    sd, ssd = dst.state_dict(), src.state_dict()
    for k in sd:
        if k in copied:
            assert torch.equal(sd[k], ssd[k]), k
        else:
            assert torch.equal(sd[k], keep[k]), k
    skipped = {k for k in ssd if k in sd and k not in copied}
    assert "adapter_vehicle.core.conv_in.weight" in skipped  # 8 vs 16 wide
    assert "adapter_vehicle.core.blocks.1.gamma" not in ssd  # dst's 2nd block
    assert "pyramid.resnet.stages.0.blocks.0.conv1.weight" in copied


def _stage_hypes(agent_type):
    """The tiny HEAL det config as a stage-1 single-type run of
    ``agent_type`` (its own slot only, as the shipped ``single/*.yaml``),
    or, for None, the collab config with ``backbone_fix: true``."""
    hypes = CHIP_SMOKE.tiny_hetero_hypes(load_yaml(TINY), "airv2x_heal")
    hypes = copy.deepcopy(hypes)
    args = hypes["model"]["args"]
    if agent_type is None:
        args["backbone_fix"] = True
        hypes["name"] = "tiny_heal_collab"
        return hypes
    counts = {t: int(t == agent_type) for t in ("vehicle", "rsu", "drone")}
    hypes["train_params"]["max_cav"] = args["max_cav"] = counts
    args["collaborators"] = [agent_type]
    args["ego_type"] = hypes["preprocess"]["ego_type"] = agent_type
    hypes["name"] = f"tiny_heal_{agent_type}"
    return hypes


def test_multi_stage_recipe_end_to_end(tmp_path, capsys):
    """Stage 1: ``tools/train.py`` trains each type's single config one
    step and saves; stage 2: ``tools/train_multi_stage.py`` loads the three
    run dirs (drone, rsu, vehicle), freezes ``backbone_fix: true`` and
    trains one step. The frozen tensors equal the stage-1 runs' (the
    vehicle's where the types share a module, each type's own encoder from
    its run); the pyramid trained; ``inference_multi_scenario`` scores the
    stage-2 run dir."""
    runs = {}
    for t in ("vehicle", "rsu", "drone"):
        path = tmp_path / f"{t}.yaml"
        save_yaml(_stage_hypes(t), str(path))
        runs[t] = train_cli.main([
            "--hypes_yaml", str(path), "--epochs", "1", "--steps_per_epoch",
            "1", "--batch_size", "1", "--device", "cpu", "--synthetic",
            "--log_dir", str(tmp_path / "logs")])
        assert find_last_epoch(runs[t]) == 1
    collab = tmp_path / "collab.yaml"
    save_yaml(_stage_hypes(None), str(collab))
    out = train_multi_stage.main([
        "--hypes_yaml", str(collab), "--vehicle_dir", runs["vehicle"],
        "--rsu_dir", runs["rsu"], "--drone_dir", runs["drone"], "--epochs", "1",
        "--steps_per_epoch", "1", "--batch_size", "1", "--device", "cpu",
        "--log_dir", str(tmp_path / "logs")])
    text = capsys.readouterr().out
    for t in ("drone", "rsu", "vehicle"):
        assert f"loaded {t} stage-1 checkpoint" in text
    assert "freezing ['encoder', 'backbone', 'shrink_conv', 'heads', " in text
    trained = torch.load(os.path.join(out, "net_epoch1"), weights_only=True)["model"]
    stage1 = {t: torch.load(os.path.join(runs[t], "net_epoch1"),
                            weights_only=True)["model"] for t in runs}
    for k in ("encoder.vehicle_pillar_vfe.dense.weight",
              "modality_backbone.stages.0.blocks.0.conv0.weight",
              "det_heads.cls_head.weight", "shrink_conv.blocks.0.conv0.bias"):
        assert torch.equal(trained[k], stage1["vehicle"][k]), k
    for t in ("rsu", "drone"):
        k = f"encoder.{t}_pillar_vfe.dense.weight"
        assert torch.equal(trained[k], stage1[t][k]), k
    k = "pyramid.resnet.stages.0.blocks.0.conv1.weight"
    assert not torch.equal(trained[k], stage1["vehicle"][k])
    # the eval CLI scores the stage-2 run dir (synthetic scenes: the config
    # names no test_dir on disk)
    res = inference_multi_scenario.main(["--model_dir", out, "--device", "cpu",
                                         "--num_scenes", "2"])
    assert np.isfinite(res["ms_per_scene"])
