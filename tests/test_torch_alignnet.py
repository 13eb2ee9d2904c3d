"""AlignNet of the port against the JAX package on the CPU, f32, through the
weight bridge, within 1e-4 x (1 + scale):

  * every module of ``models/alignnet.py``: ``ResMLP`` / ``SCAligner``,
    ``DeformConv2d`` with random non-zero offsets (its offset conv starts at
    zero, so the tests load offsets that move taps by pixels, many of them
    outside the map), ``ResidualBlock`` plain and deformable (eval, and
    train mode with its BN statistics), ``ChannelAttention``,
    ``SpatialAttention``, ``CBAMBlock``, ``XCA``, ``SDTAAligner``,
    ``DCNNet`` and ``AutoEncoder`` (eval and train);
  * the ``AlignNet`` dispatcher for each of its seven methods (``convnext``
    on fusion/adapter's ConvNeXt block); an unknown method raises in both;
  * the tiny HEAL (``chip_smoke.py:TINY_HETERO``) with an ``alignnet`` key
    built and bridged strictly for each method, and whole, ``resnet3x3``
    with ``deform``, against JAX: psm / rm / obj and the keep sets. The JAX
    HEAL compiles at ``XLA_OPT0`` (its ``weighted_fuse`` miscompiles:
    tests/test_torch_heal_models.py).
"""

import copy
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import airv2x_tpu.models.alignnet as ja
from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models import alignnet as ta
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.utils.weights import (
    flax_state_dict, init_flax_like_, load_flax_variables)
from tests.test_torch_heal_models import MARGIN, hetero_run  # noqa: F401
from tests.test_torch_intermediate import _keep_sets
from tests.torch_port_helpers import (
    CHIP_SMOKE, TINY, assert_close, jnp_tree, nchw_to_nhwc, nhwc_to_nchw,
    one_torch_thread, random_variables)  # noqa: F401
from tests.torch_train_helpers import XLA_OPT0

TOL = 1e-4
C = 16
METHODS = CHIP_SMOKE.ALIGNNET_METHODS  # each method's args, as the card runs it
# the whole-model test's variables seed: the first from 6 (with offsets
# drawn from seed 19) whose decode keeps boxes in both scenes with no IoU of
# a kept candidate pair within MARGIN of the NMS threshold
HEAL_SEED = 12


def _close(got, want, what=""):
    want = np.asarray(want)
    assert np.abs(want).max() > 0, what
    assert_close(got, want, atol=TOL * (1 + np.abs(want).max()), rtol=0, what=what)


def _x(seed=0, shape=(2, 6, 9, C)):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _offsets(var, scope, rng):
    """Offset-conv biases of a few pixels (the conv starts at zero)."""
    for path in scope:
        var = var[path]
    var["offset_conv"]["bias"] = rng.normal(0, 2.5, var["offset_conv"]["bias"].shape
                                            ).astype(np.float32)


def _run(jm, tm, x, var=None, train=False, seed=1):
    """JAX ``jm`` and the port's ``tm`` (NCHW) from one set of variables:
    (port out NHWC, JAX out, JAX batch_stats or None)."""
    var = var or random_variables(jm, x, seed=seed)
    kw = {"train": train} if "train" in inspect.signature(jm.__call__).parameters \
        else {}
    assert kw or not train
    res = jax.jit(lambda v, a: jm.apply(
        v, a, mutable=["batch_stats"] if train else False, **kw))(var, jnp.asarray(x))
    want, stats = res if train else (res, None)
    load_flax_variables(tm, var)
    tm.train(train)
    with torch.no_grad():
        got = tm(nhwc_to_nchw(x))
    return nchw_to_nhwc(got), np.asarray(want), stats


def _check_stats(tm, var, stats):
    """The port's running statistics against JAX's updated ones, named by
    the weight bridge."""
    want = flax_state_dict(tm, {"params": var["params"],
                                "batch_stats": stats["batch_stats"]})
    n = 0
    for name, buf in tm.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert_close(buf.numpy(), want[name], atol=1e-5, rtol=1e-5, what=name)
            n += 1
    assert n >= 4


def test_deform_conv_matches_jax_with_taps_outside():
    x = _x(2)
    jm = ja.DeformConv2d(8, kernel=3)
    var = random_variables(jm, x, seed=3)
    _offsets(var, ("params",), np.random.default_rng(4))
    tm = ta.DeformConv2d(C, 8, 3)
    got, want, _ = _run(jm, tm, x, var)
    _close(got, want)
    # the sampled taps: many fractional, some outside the map
    with torch.no_grad():
        off = tm.offset_conv(nhwc_to_nchw(x)).numpy()
    gy = np.arange(6)[:, None] + (np.arange(9) // 3 - 1)[:, None, None]
    sy = gy + off[:, 0::2]
    outside = (sy < 0) | (sy > 5)
    assert 0.05 < outside.mean() < 0.9
    assert np.abs(off).max() > 2.0


def test_deform_conv_starts_as_a_plain_conv():
    """At the flax initialisation the offsets are zero: the layer equals a
    3x3 SAME conv with its kernel."""
    tm = init_flax_like_(ta.DeformConv2d(C, 8, 3), seed=0)
    assert float(tm.offset_conv.weight.abs().max()) == 0.0
    x = nhwc_to_nchw(_x(5))
    with torch.no_grad():
        want = torch.nn.functional.conv2d(
            x, tm.kernel.permute(3, 2, 0, 1), tm.bias, padding=1)
        torch.testing.assert_close(tm(x), want, rtol=1e-5, atol=1e-5)


# the deformable block in eval mode is the resnet3x3 dispatch case below
@pytest.mark.parametrize("deform,train", [(False, False), (False, True),
                                          (True, True)])
def test_residual_block_matches_jax(deform, train):
    x = _x(6)
    jm = ja.ResidualBlock(C, kernel=3, deform=deform)
    var = random_variables(jm, x, seed=7)
    if deform:
        rng = np.random.default_rng(8)
        _offsets(var, ("params", "conv1"), rng)
        _offsets(var, ("params", "conv2"), rng)
    tm = ta.ResidualBlock(C, 3, deform)
    got, want, stats = _run(jm, tm, x, var, train=train)
    _close(got, want)
    if train:
        _check_stats(tm, var, stats)


MODULES = {
    "resmlp": lambda: (ja.ResMLP(2), ta.ResMLP(C, 2)),
    "scaligner": lambda: (ja.SCAligner(2, 2), ta.SCAligner(C, 2, 2)),
    "channel_attention": lambda: (ja.ChannelAttention(), ta.ChannelAttention(C)),
    "spatial_attention": lambda: (ja.SpatialAttention(), ta.SpatialAttention()),
    "cbam": lambda: (ja.CBAMBlock(), ta.CBAMBlock(C)),
    "sdta": lambda: (ja.SDTAAligner(2), ta.SDTAAligner(C, 2)),
    "dcnnet": lambda: (ja.DCNNet({"n_blocks": 2, "out_channels": [8, 12],
                                  "kernel_size": [3, 3]}),
                       ta.DCNNet({"n_blocks": 2, "out_channels": [8, 12],
                                  "kernel_size": [3, 3]}, C)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    jm, tm = MODULES[name]()
    x = _x(9)
    var = random_variables(jm, x, seed=10)
    if name == "dcnnet":
        rng = np.random.default_rng(11)
        for i in range(2):
            _offsets(var, ("params", f"DeformConv2d_{i}"), rng)
    if name == "resmlp":  # channels-last in and out
        want = np.asarray(jm.apply(var, jnp.asarray(x)))
        load_flax_variables(tm, var)
        with torch.no_grad():
            got = tm(torch.from_numpy(x)).numpy()
    else:
        got, want, _ = _run(jm, tm, x, var)
    _close(got, want, name)


def test_xca_matches_jax():
    x = _x(12, (2, 30, C))
    jm = ja.XCA()
    var = random_variables(jm, x, seed=13)
    var["params"]["temperature"] = np.array([0.5, 1.0, 2.0, 3.0], np.float32
                                            ).reshape(4, 1, 1)
    want = np.asarray(jm.apply(var, jnp.asarray(x)))
    tm = ta.XCA(C)
    load_flax_variables(tm, var)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    _close(got, want)


@pytest.mark.parametrize("train", [False, True])
def test_autoencoder_matches_jax(train):
    x = _x(14, (2, 8, 12, C))
    jm, tm = ja.AutoEncoder(feature_num=C, layer_num=2), ta.AutoEncoder(C, 2)
    var = random_variables(jm, x, seed=15)
    got, want, stats = _run(jm, tm, x, var, train=train)
    assert got.shape == want.shape == x.shape
    _close(got, want)
    if train:
        _check_stats(tm, var, stats)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_alignnet_dispatch_matches_jax(method):
    cfg = {"core_method": method, "args": copy.deepcopy(METHODS[method])}
    x = _x(16)
    jm, tm = ja.AlignNet(cfg=cfg), ta.AlignNet(cfg, C)
    if method == "identity":
        assert not list(tm.parameters())
        np.testing.assert_array_equal(np.asarray(jm.apply({}, jnp.asarray(x))), x)
        return
    var = random_variables(jm, x, seed=17)
    if method == "resnet3x3":
        rng = np.random.default_rng(18)
        for conv in ("conv1", "conv2"):
            _offsets(var, ("params", "ResAligner_0", "ResidualBlock_0", conv), rng)
    got, want, _ = _run(jm, tm, x, var)
    _close(got, want, method)


def test_unknown_method_raises_in_both():
    cfg = {"core_method": "fanet"}
    with pytest.raises(ValueError, match="fanet"):
        ta.AlignNet(cfg, C)
    with pytest.raises(ValueError, match="fanet"):
        ja.AlignNet(cfg=cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, C)))


# --- HEAL with an alignnet key -------------------------------------------


def heal_hypes(load, method):
    h = CHIP_SMOKE.tiny_hetero_hypes(load(TINY), "airv2x_heal")
    h["model"]["args"]["alignnet"] = {"core_method": method,
                                      "args": copy.deepcopy(METHODS[method])}
    return h


@pytest.mark.parametrize("method", sorted(METHODS))
def test_heal_with_alignnet_builds_and_bridges(method):
    """Each method under HEAL's ``alignnet`` key: the tiny HEAL builds, and
    the variables of JAX's AlignNet on its backbone's maps (64 channels)
    fill the port's ``alignnet`` strictly (no leaf left on either side)."""
    model = build_model(heal_hypes(load_yaml, method), device="cpu")
    c = model.modality_backbone.out_channels
    x = jnp.zeros((1, 8, 8, c))
    shapes = jax.eval_shape(lambda a: ja.AlignNet(
        cfg=heal_hypes(jax_load_yaml, method)["model"]["args"]["alignnet"]).init(
            jax.random.PRNGKey(0), a), x)
    var = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    load_flax_variables(model.alignnet, var)
    assert bool(list(model.alignnet.parameters())) == (method != "identity")


def test_heal_with_deformable_alignnet_matches_jax(hetero_run):  # noqa: F811
    """The tiny HEAL with ``resnet3x3`` / ``deform`` AlignNet (offsets of a
    few pixels) on the two perturbed scenes: psm / rm / obj and the keep
    sets."""
    batch, _ = hetero_run
    jh = heal_hypes(jax_load_yaml, "resnet3x3")
    jm = jax_build_model(jh)
    var = random_variables(jm, jnp_tree(batch), seed=HEAL_SEED, train=False)
    rng = np.random.default_rng(19)
    for conv in ("conv1", "conv2"):
        _offsets(var, ("params", "alignnet", "ResAligner_0", "ResidualBlock_0",
                       conv), rng)
    fn = jax.jit(lambda v, b: jm.apply(v, b, train=False))
    args = (var, jnp_tree(batch))
    want = {k: np.asarray(v, np.float32)
            for k, v in fn.lower(*args).compile(XLA_OPT0)(*args).items()}
    th = heal_hypes(load_yaml, "resnet3x3")
    model = build_model(th, device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch_cpu(batch))
    for k in ("psm", "rm", "obj"):
        _close(got[k].numpy(), want[k], k)
    kept = 0
    for b in range(2):  # _keep_sets asserts the NMS margin
        keep = _keep_sets(th, want, got, b)
        np.testing.assert_array_equal(keep["torch"], keep["jax"])
        kept += int(keep["jax"].sum())
    assert kept > 0


def batch_to_torch_cpu(batch):
    from airv2x_tpu_torch.data.synthetic import batch_to_torch

    return batch_to_torch(batch, "cpu")
