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
from airv2x_tpu.data.synthetic import add_camera_inputs as jax_add_camera_inputs
from airv2x_tpu.data.synthetic import make_scene as jax_make_scene
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops.anchors import generate_anchor_grid as jax_anchor_grid
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import (
    add_camera_inputs, batch_to_torch, make_scene, perturb_poses)
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
from airv2x_tpu_torch.models.nn import MaskedBatchNorm
from airv2x_tpu_torch.models.registry import MODEL_REGISTRY
from airv2x_tpu_torch.utils.weights import (
    cast_weights_, flax_state_dict, init_flax_like_, init_random_,
    load_flax_variables)
from tests.torch_port_helpers import (
    CAMERA, CHIP_SMOKE, FLAGSHIP, REPO, SCOPE, SEG, TINY, V2XVIT, V2XVIT_SEG,
    one_torch_thread, random_variables)



CONFIGS = [TINY, FLAGSHIP, SEG, CAMERA, V2XVIT, V2XVIT_SEG, SCOPE]
IDS = ["tiny", "flagship", "seg", "camera", "v2xvit", "v2xvit_seg", "scope"]


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


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
def test_load_yaml_matches_jax(cfg):
    _assert_same_tree(load_yaml(cfg), jax_load_yaml(cfg))


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
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


@pytest.mark.parametrize("with_depth", [True, False])
def test_add_camera_inputs_bit_identical(with_depth):
    """The camera inputs of the benchmarked camera scene, drawn after
    ``make_scene`` from the same generator (every type's imgs over all L
    slots), at a small image size."""
    args = load_yaml(CAMERA)["model"]["args"]
    args["max_cav"] = {"vehicle": 3, "rsu": 2, "drone": 1}
    ncam = {"vehicle": 6, "rsu": 4, "drone": 1}
    out = []
    for layout, scene, add in (
            (SlotLayout.from_args(args), make_scene, add_camera_inputs),
            (JaxSlotLayout.from_args(args), jax_make_scene,
             jax_add_camera_inputs)):
        rng = np.random.default_rng(9)
        b, _ = scene(rng, layout, points_per_agent=500, pts_per_box=20)
        add(b, layout, rng, img_hw=(16, 24), ncam=ncam, with_depth=with_depth)
        out.append((b, rng.uniform()))  # the generator's state after
    (got, got_next), (want, want_next) = out
    assert got_next == want_next
    assert set(got) == set(want)
    for t in ("vehicle", "rsu", "drone"):
        g, w = got[f"cam_{t}"], want[f"cam_{t}"]
        assert set(g) == set(w)
        assert g["imgs"].shape == (6, ncam[t], 16, 24, 4 if with_depth else 3)
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{t} {k}")


def test_perturb_poses_composes_pairwise_t_full():
    """``pairwise_t_full[i, j]`` is ``pairwise_t[i]^-1 pairwise_t[j]``: its
    ego row is ``pairwise_t``, its diagonal the identity, and its pairs
    compose; the poses and delays are those drawn without it."""
    scene, _ = make_scene(np.random.default_rng(3), SlotLayout((2, 2, 1)),
                          points_per_agent=16, pts_per_box=4)
    batch = {k: np.stack([v, v]) for k, v in scene.items()}
    plain = {k: batch[k].copy() for k in ("pairwise_t", "prior_encoding")}
    perturb_poses(batch, np.random.default_rng(4))
    perturb_poses(plain, np.random.default_rng(4))
    for k in plain:
        np.testing.assert_array_equal(batch[k], plain[k])
    full, pt = batch["pairwise_t_full"], batch["pairwise_t"]
    assert full.shape == (2, 5, 5, 4, 4) and full.dtype == np.float32
    assert np.abs(pt[:, 1:] - np.eye(4)).max() > 0.05
    np.testing.assert_allclose(full[:, 0], pt, rtol=0, atol=1e-6)
    for i in range(5):
        np.testing.assert_allclose(full[:, i, i], np.broadcast_to(np.eye(4), (2, 4, 4)),
                                   rtol=0, atol=1e-6)
        for j in range(5):
            for k in range(5):
                np.testing.assert_allclose(full[:, i, j] @ full[:, j, k],
                                           full[:, i, k], rtol=0, atol=1e-6)


@pytest.mark.parametrize("cfg", CONFIGS, ids=IDS)
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


def test_bridge_fills_the_camera_model():
    """The full-width camera det model, max_cav cut to the benchmarked scene:
    every flax leaf (trunks, LSS heads, BEV encoders) fills one tensor. The
    flax variables' shapes come from an abstract init, no forward runs."""
    import jax

    hypes = jax_load_yaml(CAMERA)
    hypes["model"]["args"]["max_cav"] = {"vehicle": 3, "rsu": 2, "drone": 1}
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(0), layout, points_per_agent=64,
                          pts_per_box=8)
    jax_add_camera_inputs(b, layout, np.random.default_rng(1), img_hw=(8, 8),
                          ncam={"vehicle": 6, "rsu": 4, "drone": 1})
    shapes = jax.tree.map(
        lambda v: jax.ShapeDtypeStruct((1,) + v.shape, v.dtype), b)
    for t in ("vehicle", "rsu", "drone"):  # the images at full size
        imgs = shapes[f"cam_{t}"]["imgs"]
        shapes[f"cam_{t}"]["imgs"] = jax.ShapeDtypeStruct(
            imgs.shape[:3] + (256, 352, 4), imgs.dtype)
    variables = random_variables(jax_build_model(hypes), shapes, seed=2,
                                 train=False)
    thypes = load_yaml(CAMERA)
    thypes["model"]["args"]["max_cav"] = {"vehicle": 3, "rsu": 2, "drone": 1}
    model = build_model(thypes, device="cpu")
    load_flax_variables(model, variables)  # raises on any leftover
    n_leaves = sum(len(v) for col in variables.values() for v in _leaves(col))
    n_tensors = sum(t.numel() for k, t in model.state_dict().items()
                    if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_tensors
    dw = model.encoder.rsu_lss.camencode.trunk.block3.depthwise_conv
    want = variables["params"]["encoder"]["rsu_lss"]["camencode"]["trunk"][
        "block3"]["depthwise_conv"]["kernel"]  # HWIO (5, 5, 1, 144)
    assert dw.weight.shape == (144, 1, 5, 5)
    np.testing.assert_array_equal(dw.weight.numpy(), want.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("cfg", [V2XVIT, V2XVIT_SEG], ids=["det", "seg"])
def test_bridge_fills_the_v2xvit_model(cfg):
    """The full-width V2X-ViT model: every flax leaf (encoder, backbone,
    shrink, the transformer's auto-named Dense / LayerNorm scopes, relation
    tensors and position biases, heads) fills one tensor, strict. The flax
    variables' shapes come from an abstract init, no forward runs."""
    import jax

    hypes = jax_load_yaml(cfg)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(0), layout, points_per_agent=64,
                          pts_per_box=8)
    shapes = jax.tree.map(
        lambda v: jax.ShapeDtypeStruct((1,) + v.shape, v.dtype), b)
    variables = random_variables(jax_build_model(hypes), shapes, seed=3,
                                 train=False)
    model = build_model(load_yaml(cfg), device="cpu")
    load_flax_variables(model, variables)  # raises on any leftover
    n_leaves = sum(len(v) for col in variables.values() for v in _leaves(col))
    n_tensors = sum(t.numel() for k, t in model.state_dict().items()
                    if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_tensors
    enc = variables["params"]["fusion_net"]["V2XTEncoder_0"]
    assert sorted(enc) == [
        "Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_4", "Dense_5",
        "LayerNorm_0", "LayerNorm_1", "LayerNorm_2", "RTE_0",
        "V2XFusionBlock_0", "V2XFusionBlock_1", "V2XFusionBlock_2"]
    pw = enc["V2XFusionBlock_2"]["PyramidWindowAttention_0"]
    tpw = model.fusion_net.encoder.blocks[2].pwin[0]
    np.testing.assert_array_equal(
        tpw.windows[0].pos_embedding.detach().numpy(),
        pw["BaseWindowAttention_0"]["pos_embedding"])
    np.testing.assert_array_equal(
        tpw.split_attn.fc2.weight.detach().numpy(),
        pw["SplitAttn_0"]["Dense_1"]["kernel"].T)
    ln = enc["V2XFusionBlock_1"]["LayerNorm_1"]
    np.testing.assert_array_equal(
        model.fusion_net.encoder.blocks[1].norms[1].weight.detach().numpy(),
        ln["scale"])


def _v2xvit_full_width():
    hypes = load_yaml(V2XVIT)
    hypes["model"]["args"]["max_cav"] = {"vehicle": 3, "rsu": 2, "drone": 1}
    return build_model(hypes, device="cpu")


def test_cast_weights_keeps_the_v2xvit_f32_parts():
    """Under the bf16 serving cast RTE's Linear, every LayerNorm and every
    BatchNorm-type module stay f32; the typed and window Linears, the
    relation tensors and the position biases go bf16."""
    model = cast_weights_(_v2xvit_full_width(), torch.bfloat16)
    enc = model.fusion_net.encoder
    keep = [m for m in model.modules() if isinstance(
        m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d, MaskedBatchNorm))]
    assert sum(isinstance(m, torch.nn.LayerNorm) for m in keep) == 3 * 3 + 3
    assert sum(isinstance(m, MaskedBatchNorm) for m in keep) == 3
    for m in keep + [enc.rte]:
        for name, t in list(m.named_parameters()) + list(m.named_buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32, (m, name)
    att = enc.blocks[0].att[0]
    for t in (att.relation_att, att.relation_msg, att.q[0].weight,
              att.a[1].bias, enc.blocks[2].pwin[0].windows[1].pos_embedding,
              enc.ffn[5].weight, model.det_heads.cls_head.weight):
        assert t.dtype == torch.bfloat16


@pytest.mark.parametrize("init", [init_flax_like_, init_random_],
                         ids=["flax_like", "random"])
def test_initialisers_cover_the_v2xvit_leaves(init):
    """Both initialisers reach the transformer's own leaves: LayerNorm 1 /
    0, xavier-uniform relation tensors (flax's fans: the leading axes count
    as receptive field), standard-normal position biases; and they are
    repeatable from their seed."""
    from airv2x_tpu_torch.models.fusion.v2xvit import relation_init_limit

    model = init(_v2xvit_full_width(), seed=4)
    enc = model.fusion_net.encoder
    for norm in (enc.norms[2], enc.blocks[0].norms[1],
                 enc.blocks[1].pwin[0].split_attn.norm):
        assert (norm.weight == 1).all() and (norm.bias == 0).all()
    att = enc.blocks[1].att[0]
    lim = relation_init_limit(att.relation_att.shape)  # (4, 8, 32, 32)
    assert lim == pytest.approx((6 / (2 * 32 * 4 * 8)) ** 0.5)
    for p in (att.relation_att, att.relation_msg):
        assert lim * 0.99 < float(p.abs().max()) <= lim
        assert abs(float(p.mean())) < 0.05 * lim
    pos = enc.blocks[0].pwin[0].windows[2].pos_embedding  # (7, 7)
    assert 0.5 < float(pos.std()) < 1.5
    again = init(_v2xvit_full_width(), seed=4)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_bridge_fills_the_scope_model():
    """The full-width SCOPE model (5 vehicles, 2 frames, the LSTM at 256
    channels on 100 x 352): every flax leaf (the ResNet blocks, the three
    deform_fuse_<i> transformers, the eight STPN pyramids of the cell, the
    raw biases and initial cell state) fills one tensor, strict, the raw
    ones permuted from channels-last. The flax variables' shapes come from
    an abstract init, no forward runs."""
    import jax

    hypes = jax_load_yaml(SCOPE)
    layout = SlotLayout.from_args(hypes["model"]["args"])
    assert layout.counts == (5, 0, 0)
    batch = CHIP_SMOKE.scope_scene(
        np.random.default_rng(0), layout, 2, hypes["preprocess"]["cav_lidar_range"],
        points_per_agent=64, pts_per_box=8, num_agents={"vehicle": 5})
    shapes = jax.tree.map(lambda v: jax.ShapeDtypeStruct(v.shape, v.dtype), batch)
    variables = random_variables(jax_build_model(hypes), shapes, seed=5,
                                 train=False)
    model = build_model(load_yaml(SCOPE), device="cpu")
    load_flax_variables(model, variables)  # raises on any leftover
    n_leaves = sum(len(v) for col in variables.values() for v in _leaves(col))
    n_tensors = sum(t.numel() for k, t in model.state_dict().items()
                    if not k.endswith("num_batches_tracked"))
    assert n_leaves == n_tensors
    params = variables["params"]
    assert sorted(k for k in params if k.startswith("deform_fuse")) == [
        "deform_fuse_0", "deform_fuse_1", "deform_fuse_2"]
    att = params["deform_fuse_2"]["transformer"]["layer0_cross_attn"]
    np.testing.assert_array_equal(
        model.fuse_modules[2].transformer.layer0_cross_attn.value_proj.weight.numpy(),
        att["value_proj"]["kernel"].T)
    lstm = params["temporal_fusion"]["sync_lstm"]
    cell = model.temporal_fusion.sync_lstm.lstmcell
    assert lstm["lstmcell"]["b_f"].shape == (1, 100, 352, 64)
    assert cell.b_f.shape == (1, 64, 100, 352)
    np.testing.assert_array_equal(cell.b_f.detach().numpy(),
                                  lstm["lstmcell"]["b_f"].transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        model.temporal_fusion.sync_lstm.init_c.detach().numpy(),
        lstm["init_c"].transpose(2, 0, 1))
    np.testing.assert_array_equal(
        cell.v_o.conv7_1.weight.detach().numpy(),
        lstm["lstmcell"]["v_o"]["conv7_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        model.backbone.stages[2].blocks[0].down_conv.weight.detach().numpy(),
        params["backbone"]["stages_2"]["BasicBlock_0"]["Conv_2"]["kernel"]
        .transpose(3, 2, 0, 1))


def _scope_full_width():
    return build_model(load_yaml(SCOPE), device="cpu")


def test_cast_weights_keeps_the_scope_f32_parts():
    """Under the bf16 serving cast the LSTM's raw biases and initial cell
    state stay f32 (the JAX package adds them in f32), as do the
    BatchNorms (eps 1e-5 in the LSTM, 1e-3 in the backbone) and the
    deformable attention's LayerNorms; the convolutions and Linears go
    bf16."""
    model = cast_weights_(_scope_full_width(), torch.bfloat16)
    sync = model.temporal_fusion.sync_lstm
    for t in (sync.init_c, sync.lstmcell.b_i, sync.lstmcell.b_o,
              sync.bn_pre_1.weight, sync.lstmcell.u_c.bn8_2.running_var,
              model.backbone.stages[0].blocks[0].bn0.weight,
              model.fuse_modules[0].transformer.layer0_ca_norm.weight):
        assert t.dtype == torch.float32
    for t in (sync.conv_pre_1.weight, sync.lstmcell.v_f.conv2_2.weight,
              model.fuse_modules[1].transformer.layer0_cross_attn.output_proj.weight,
              model.backbone.stages[1].blocks[2].conv1.weight,
              model.cls_head.weight):
        assert t.dtype == torch.bfloat16
    assert sync.bn_pre_1.eps == 1e-5 and sync.lstmcell.u_i.bn1_1.eps == 1e-5
    assert model.backbone.stages[0].blocks[0].bn0.eps == 1e-3


@pytest.mark.parametrize("init", [init_flax_like_, init_random_],
                         ids=["flax_like", "random"])
def test_initialisers_cover_the_scope_leaves(init):
    """Both initialisers reach the LSTM's raw parameters as flax initialises
    them: the biases zero, the initial cell state U[0, 1); repeatable from
    their seed."""
    model = init(_scope_full_width(), seed=4)
    sync = model.temporal_fusion.sync_lstm
    for g in "ifco":
        assert (getattr(sync.lstmcell, f"b_{g}") == 0).all()
    c = sync.init_c
    assert 0 <= float(c.min()) and float(c.max()) < 1
    assert abs(float(c.mean()) - 0.5) < 0.01
    again = init(_scope_full_width(), seed=4)
    assert torch.equal(again.temporal_fusion.sync_lstm.init_c, c)


FAMILY_CONFIGS = [os.path.join(REPO, f"hypes_yaml/airv2x/lidar/{p}.yaml")
                  for p in ("det/att_fusion", "det/intermediate",
                            "det/max_fusion", "det/cobevt", "det/v2vnet",
                            "seg/cobevt", "seg/v2vnet")]
FAMILY_IDS = [p.split("lidar/")[1][:-5] for p in FAMILY_CONFIGS]


def _batch_shapes(hypes):
    """The abstract batch of a small ``make_scene`` call (batch 1)."""
    import jax

    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    b, _ = jax_make_scene(np.random.default_rng(0), layout, points_per_agent=64,
                          pts_per_box=8)
    return jax.tree.map(lambda v: jax.ShapeDtypeStruct((1,) + v.shape, v.dtype), b)


def _n_tensors(model):
    return sum(t.numel() for k, t in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("cfg", FAMILY_CONFIGS, ids=FAMILY_IDS)
def test_bridge_fills_the_family_model(cfg):
    """The full-width intermediate-family models other than When2com (15
    slots): every flax leaf (encoder, backbone, shrink, the fusion's
    auto-named scopes, heads) fills one tensor, strict. The flax variables'
    shapes come from an abstract init, no forward runs."""
    hypes = jax_load_yaml(cfg)
    variables = random_variables(jax_build_model(hypes), _batch_shapes(hypes),
                                 seed=6, train=False)
    model = build_model(load_yaml(cfg), device="cpu")
    load_flax_variables(model, variables)  # raises on any leftover
    n_leaves = sum(len(v) for col in variables.values() for v in _leaves(col))
    assert n_leaves == _n_tensors(model)
    params = variables["params"]
    method = hypes["model"]["core_method"]
    if method == "airv2x_cobevt":
        fax = params["fusion_net"]
        assert sorted(fax) == ["Dense_0", "LayerNorm_0", "SwapFusionBlock_0",
                               "SwapFusionBlock_1"]
        blk = fax["SwapFusionBlock_1"]
        assert sorted(blk) == [
            "LayerNorm_0", "LayerNorm_1", "LayerNorm_2", "LayerNorm_3",
            "WindowedAgentAttention_0", "WindowedAgentAttention_1",
            "_FeedForward_0", "_FeedForward_1"]
        tblk = model.fusion_net.blocks[1]
        att = blk["WindowedAgentAttention_1"]
        assert att["relative_position_bias"].shape == (29 * 7 * 7, 8)
        np.testing.assert_array_equal(
            tblk.attn[1].relative_position_bias.detach().numpy(),
            att["relative_position_bias"])
        np.testing.assert_array_equal(tblk.attn[1].to_out.weight.detach().numpy(),
                                      att["Dense_1"]["kernel"].T)
        np.testing.assert_array_equal(tblk.norms[2].weight.detach().numpy(),
                                      blk["LayerNorm_2"]["scale"])
        np.testing.assert_array_equal(tblk.ffn[0].down.bias.detach().numpy(),
                                      blk["_FeedForward_0"]["Dense_1"]["bias"])
    elif method == "airv2x_v2vnet":
        v2v = params["fusion_net"]
        assert set(v2v) == {"Conv_0", "ConvGRUCell_0", "Dense_0"}
        np.testing.assert_array_equal(
            model.fusion_net.gru.conv_can.weight.detach().numpy(),
            v2v["ConvGRUCell_0"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
        assert model.fusion_net.gru.conv_gates.weight.shape == (512, 768, 3, 3)
        np.testing.assert_array_equal(model.fusion_net.out.weight.detach().numpy(),
                                      v2v["Dense_0"]["kernel"].T)
    else:
        assert "fusion_net" not in params and model.fusion_net is None


def _cut_when2com(hypes, nx, ny):
    """A When2com config (from either package's loader) with its BEV grid
    cut to nx x ny cells of 0.4 m, and its fusion's map size to match."""
    hypes["preprocess"]["cav_lidar_range"] = [-0.2 * nx, -0.2 * ny, -3.0,
                                              0.2 * nx, 0.2 * ny, 1.0]
    hypes["model"]["args"]["when2com_fusion"].update(H=ny // 2, W=nx // 2)
    return hypes


@pytest.mark.parametrize("task", ["det", "seg"])
def test_bridge_names_and_shapes_of_the_when2com_model(task):
    """The full-width When2com model (its two 563,200 -> 256 MLP inputs,
    144 M weights each): the bridge's names and shapes equal the port's
    state_dict, strict, from the abstract init and a model built on the meta
    device, so no weight is materialised."""
    import jax

    path = os.path.join(REPO, f"hypes_yaml/airv2x/lidar/{task}/when2com.yaml")
    hypes = jax_load_yaml(path)
    jmodel = jax_build_model(hypes)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.PRNGKey(0)}, b, train=False),
        _batch_shapes(hypes))
    zero = np.zeros((), np.float32)
    views = jax.tree.map(lambda s: np.broadcast_to(zero, s.shape), shapes)
    thypes = load_yaml(path)
    args = dict(thypes["model"]["args"], preprocess=thypes["preprocess"],
                postprocess=thypes["postprocess"])
    with torch.device("meta"):
        model = MODEL_REGISTRY["airv2x_when2com"](args)
    sd = flax_state_dict(model, views)
    want = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert want["fusion_net.key_net.fc.0.weight"] == (256, 25 * 88 * 256)
    assert want["fusion_net.query_net.fc.2.weight"] == (32, 128)
    assert shapes["params"]["fusion_net"]["key_net"]["Dense_0"]["kernel"].shape == (
        563200, 256)


def test_bridge_fills_the_when2com_model_at_a_reduced_map():
    """The When2com det config with its grid cut to 64 x 32 cells (maps of
    16 x 32): the value bridge fills every tensor, strict, the MLPs' first
    Linear from the kernel of the channels-last flatten."""
    path = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/when2com.yaml")
    thypes = _cut_when2com(load_yaml(path), 64, 32)
    jhypes = _cut_when2com(jax_load_yaml(path), 64, 32)
    variables = random_variables(jax_build_model(jhypes), _batch_shapes(jhypes),
                                 seed=7, train=False)
    model = build_model(thypes, device="cpu")
    load_flax_variables(model, variables)
    n_leaves = sum(len(v) for col in variables.values() for v in _leaves(col))
    assert n_leaves == _n_tensors(model)
    w2c = variables["params"]["fusion_net"]
    assert sorted(w2c) == ["Dense_0", "PolicyNet_0", "key_net", "query_net"]
    kernel = w2c["key_net"]["Dense_0"]["kernel"]
    assert kernel.shape == (4 * 8 * 256, 256)
    np.testing.assert_array_equal(
        model.fusion_net.key_net.fc[0].weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(
        model.fusion_net.policy.blocks[4].bn.running_var.numpy(),
        variables["batch_stats"]["fusion_net"]["PolicyNet_0"]["_ConvBNRelu_4"][
            "BatchNorm_0"]["var"])


def _family_small(name):
    """A family model on the tiny config (its fusion at 64 channels), for
    the cast and initialiser tests."""
    hypes = CHIP_SMOKE.tiny_family_hypes(load_yaml(TINY), name)
    return build_model(hypes, device="cpu")


@pytest.mark.parametrize("name", ["airv2x_cobevt", "airv2x_v2vnet",
                                  "airv2x_when2com"])
def test_cast_weights_keeps_the_family_f32_parts(name):
    """Under the bf16 serving cast every BatchNorm (When2com's policy CNN
    included) and LayerNorm (CoBEVT's) stays f32; the convs, Linears, GRU
    and the relative position bias tables go bf16."""
    model = cast_weights_(_family_small(name), torch.bfloat16)
    keep = [m for m in model.modules() if isinstance(
        m, (torch.nn.LayerNorm, torch.nn.BatchNorm2d, MaskedBatchNorm))]
    for m in keep:
        for t in list(m.parameters()) + list(m.buffers()):
            if t.is_floating_point():
                assert t.dtype == torch.float32, m
    fusion = model.fusion_net
    if name == "airv2x_cobevt":
        assert sum(isinstance(m, torch.nn.LayerNorm) for m in keep) == 4 + 1
        low = [fusion.blocks[0].attn[1].relative_position_bias,
               fusion.blocks[0].attn[0].to_qkv.weight, fusion.blocks[0].ffn[1].up.bias,
               fusion.out.weight]
    elif name == "airv2x_v2vnet":
        low = [fusion.msg_cnn.weight, fusion.gru.conv_gates.bias,
               fusion.gru.conv_can.weight, fusion.out.weight]
    else:
        assert sum(isinstance(m, torch.nn.BatchNorm2d)
                   for m in fusion.modules()) == 5
        low = [fusion.policy.blocks[0].conv.weight, fusion.key_net.fc[0].weight,
               fusion.query_net.fc[2].bias, fusion.query_proj.weight]
    for t in low:
        assert t.dtype == torch.bfloat16
    assert model.det_heads.cls_head.weight.dtype == torch.bfloat16


@pytest.mark.parametrize("init", [init_flax_like_, init_random_],
                         ids=["flax_like", "random"])
@pytest.mark.parametrize("name", ["airv2x_cobevt", "airv2x_v2vnet",
                                  "airv2x_when2com"])
def test_initialisers_cover_the_family_leaves(init, name):
    """Both initialisers reach every tensor of the fusion (none keeps the
    NaN it was filled with): LayerNorms 1 / 0, the relative position bias
    tables normal(0.02), convs and Linears by their rule; and they are
    repeatable from their seed."""
    model = _family_small(name)
    with torch.no_grad():
        for t in model.fusion_net.state_dict().values():
            if t.is_floating_point():
                t.fill_(float("nan"))
    init(model, seed=5)
    for k, t in model.fusion_net.state_dict().items():
        assert not torch.isnan(t).any(), k
    if name == "airv2x_cobevt":
        for blk in model.fusion_net.blocks:
            for att in blk.attn:
                bias = att.relative_position_bias
                assert 0.015 < float(bias.std()) < 0.025
                assert abs(float(bias.mean())) < 0.005
            for norm in blk.norms:
                assert (norm.weight == 1).all() and (norm.bias == 0).all()
    again = init(_family_small(name), seed=5)
    for (k, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), k


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
    names = {os.path.relpath(p, REPO) for p in files}
    for module in ("ops/conv3x3.py", "ops/pillar_reduce.py", "ops/warp.py",
                   "models/heads.py", "models/nn.py", "models/camera/lss.py",
                   "models/camera/trunks.py", "models/fusion/v2xvit.py",
                   "models/v2xvit_model.py", "models/intermediate_models.py",
                   "models/lss_model.py", "models/registry.py",
                   "tools/train.py",
                   "models/fusion/cobevt.py", "models/fusion/v2vnet.py",
                   "models/fusion/when2com.py", "data/airv2x_dataset.py",
                   "data/augment.py", "data/camera.py", "data/loader.py",
                   "data/pcd.py", "data/prefetch.py", "eval/ap.py",
                   "eval/seg_metrics.py", "tools/chip_ap_gate.py",
                   "tools/inference.py", "tools/inference_airv2x.py",
                   "tools/inference_airv2x_seg.py",
                   "tools/inference_multi_scenario.py", "utils/transforms.py",
                   "loss/depth_loss.py", "loss/__init__.py",
                   "parallel/train.py", "models/where2comm_model.py",
                   "models/fusion/scope.py", "data/synthetic.py",
                   "data/opv2v_dataset.py", "data/dair_dataset.py",
                   "tools/dair_convert.py", "loss/point_pillar_binary.py",
                   "models/point_pillar_models.py"):
        assert os.path.join("airv2x_tpu_torch", module) in names, module
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
