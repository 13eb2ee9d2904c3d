"""K4's plain version, the im2col form, the support gates and the
ConvBNReLU backends of the PyTorch port against the JAX package, whose
Pallas conv runs in interpret mode here (as tests/test_pallas_conv.py runs
it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models.nn import ConvBNReLU as JaxConvBNReLU
from airv2x_tpu.models.nn import PallasConv3x3 as JaxPallasConv3x3
from airv2x_tpu.ops import pallas_conv as jconv
from airv2x_tpu_torch.models.nn import ConvBNReLU, PallasConv3x3
from airv2x_tpu_torch.ops.conv3x3 import (
    F32_KERNELS,
    KERNELS,
    SMEM_LIMIT,
    conv3x3_im2col,
    conv3x3_plan,
    conv3x3_same,
    conv3x3_same_plain,
    make_plan,
    pack_f32_weights,
    supports_conv3x3,
    supports_conv3x3_allmaps,
    tf32_split,
)
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_kernels_gpu import CONV_SHAPES
from tests.torch_port_helpers import (
    assert_close, nchw_to_nhwc, nhwc_to_nchw, random_variables)

TOL = 1e-4  # f32, as tests/test_pallas_conv.py
TOL_BF16 = 2e-2  # bf16 output: both sides accumulate f32 over bf16 operands
SHAPES = [
    (2, 8, 16, 8, 16),   # aligned W
    (1, 5, 11, 8, 8),    # W padded to the TPU's sublane tile
    (3, 10, 24, 16, 8),  # Cout < Cin
    (6, 13, 22, 8, 8),   # flagship-like: 6 maps, odd spatial
]


def _inputs(seed, b, h, w, c, co, affine=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((3, 3, c, co)) * 0.1).astype(np.float32)
    if not affine:
        return x, k
    s = (rng.standard_normal(co) * 0.5 + 1.0).astype(np.float32)
    bias = rng.standard_normal(co).astype(np.float32)
    return x, k, s, bias


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
@pytest.mark.parametrize("b,h,w,c,co", SHAPES)
def test_plain_matches_pallas_f32(b, h, w, c, co, allmaps):
    x, k = _inputs(0, b, h, w, c, co)
    want = jconv.conv3x3_same(jnp.asarray(x), jnp.asarray(k), allmaps=allmaps,
                              interpret=True)
    got = conv3x3_same(*_torch(x, k), allmaps=allmaps)  # CPU: the plain version
    assert got.shape == (b, h, w, co) and got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), TOL, TOL, "conv3x3 f32")


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_plain_matches_pallas_bf16(allmaps):
    x, k = _inputs(1, 2, 6, 18, 16, 16)
    want = jconv.conv3x3_same(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(k, jnp.bfloat16), allmaps=allmaps,
                              interpret=True)
    got = conv3x3_same_plain(*_torch(x, k, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert_close(got.float().numpy(), np.asarray(want, np.float32), TOL_BF16,
                 TOL_BF16, "conv3x3 bf16")


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_fused_affine_relu_epilogue(allmaps):
    x, k, s, bias = _inputs(3, 2, 8, 16, 8, 16, affine=True)
    want = jconv.conv3x3_same(*map(jnp.asarray, (x, k, s, bias)), relu=True,
                              allmaps=allmaps, interpret=True)
    got = conv3x3_same(*_torch(x, k, s, bias), relu=True, allmaps=allmaps)
    assert_close(got.numpy(), np.asarray(want), TOL, TOL, "epilogue")
    assert float(got.min()) == 0.0 and float(got.max()) > 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_im2col_matches_jax(dtype):
    x, k, s, bias = _inputs(4, 2, 7, 9, 8, 16, affine=True)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jconv.conv3x3_im2col(jnp.asarray(x, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(s), jnp.asarray(bias), relu=True)
    xt, kt = _torch(x, k, dtype=dtype)
    got = conv3x3_im2col(xt, kt, *_torch(s, bias), relu=True)
    assert got.dtype == dtype and got.shape == (2, 7, 9, 16)
    tol = TOL if dtype == torch.float32 else TOL_BF16
    assert_close(got.float().numpy(), np.asarray(want, np.float32), tol, tol,
                 "im2col")


GATE_CASES = [
    ((6, 100, 352, 64), 64),
    ((6, 25, 88, 256), 256),
    ((6, 50, 176, 128), 128),
    ((6, 100, 352, 256), 256),  # the 256-ch shrink at full BEV res
    ((1, 16, 16, 12), 12),      # odd channel counts
    ((2, 1, 16, 8), 8),         # too short
    ((6, 200, 704, 64), 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,features", GATE_CASES)
def test_support_gates_match_jax(shape, features, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    assert supports_conv3x3(shape, dtype, features) == \
        jconv.supports_pallas_conv3x3(shape, jdt, features)
    assert supports_conv3x3_allmaps(shape, dtype, features) == \
        jconv.supports_pallas_conv3x3_allmaps(shape, jdt, features)


@pytest.mark.parametrize("mode", ["xla", "auto", "pallas", "im2col"])
def test_convbnrelu_modes_match_jax(monkeypatch, mode):
    """Each port backend from the same flax variables against the JAX block
    under the same ``AIRV2X_CONV_KERNEL`` (its Pallas branch in interpret
    mode), and the torch cuDNN branch against the same flax block."""
    x = np.random.default_rng(5).standard_normal((2, 8, 16, 8)).astype(
        np.float32)
    jblk = JaxConvBNReLU(8, dtype=jnp.float32)
    var = random_variables(jblk, jnp.asarray(x), seed=6, train=False)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    want = np.asarray(jblk.apply(var, jnp.asarray(x), False))
    tblk = ConvBNReLU(8, 8).eval()
    load_flax_variables(tblk, var)
    with torch.no_grad():
        got = tblk(nhwc_to_nchw(x))
    assert_close(nchw_to_nhwc(got), want, 1e-5, 1e-5, mode)
    assert np.abs(want).max() > 0


def test_convbnrelu_pallas_refuses_outside_gate(monkeypatch):
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    blk = ConvBNReLU(12, 12).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="support gate"):
        blk(torch.zeros(1, 12, 16, 16))
    blk.train()  # training always takes the cuDNN branch
    assert blk(torch.zeros(2, 12, 16, 16)).shape == (2, 12, 16, 16)


def test_convbnrelu_fold_follows_weight_updates(monkeypatch):
    """The folded (w, scale, bias) is cached; an in-place change of a BN
    statistic or the conv weight must refresh it."""
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    blk = ConvBNReLU(8, 8).eval()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 8, 6, 7)).astype(np.float32))
    with torch.no_grad():
        first = blk(x)
        blk.bn.running_var.mul_(4.0)
        blk.conv.weight.add_(0.5)
        second = blk(x)
        monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
        ref = blk(x)
    assert not torch.equal(first, second)
    torch.testing.assert_close(second, ref, atol=1e-5, rtol=1e-5)


def test_convbnrelu_fold_caches_the_f32_split(monkeypatch):
    """In f32 the fold also holds the kernel's repacked tf32 split of the
    folded weight (made once per weight version); bf16 has none; the CPU
    forward, the plain version, ignores it; a cuDNN-mode forward drops the
    cache."""
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    blk = ConvBNReLU(8, 16).eval()
    w, scale, bias, packed = blk._fold(torch.float32)
    assert torch.equal(packed, pack_f32_weights(w))
    assert blk._fold(torch.float32)[3] is packed  # cached
    assert blk._fold(torch.bfloat16)[3] is None
    with torch.no_grad():
        blk.conv.weight.mul_(2.0)
    assert not torch.equal(blk._fold(torch.float32)[3], packed)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (1, 8, 5, 9)).astype(np.float32))
    with torch.no_grad():
        got = blk(x)
        want = conv3x3_same_plain(x.permute(0, 2, 3, 1), *blk._fold(
            torch.float32)[:3], relu=True).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert blk._fold_val is not None
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
    with torch.no_grad():
        blk(x)
    assert blk._fold_key is None and blk._fold_val is None


def test_pallas_conv3x3_module_matches_jax():
    x = np.random.default_rng(8).standard_normal((2, 7, 10, 8)).astype(
        np.float32)
    jmod = JaxPallasConv3x3(16, dtype=jnp.float32, interpret=True)
    var = random_variables(jmod, jnp.asarray(x), seed=9)
    want = np.asarray(jmod.apply(var, jnp.asarray(x)))
    tmod = PallasConv3x3(8, 16)
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = nchw_to_nhwc(tmod(nhwc_to_nchw(x)))
    assert_close(got, want, TOL, TOL, "PallasConv3x3")


def test_kernel_wrapper_checks_shapes():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="does not fit"):
        conv3x3_same(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="scale"):
        conv3x3_same(x, torch.zeros(3, 3, 8, 8), torch.ones(4))



# the flagship backbone's three stages and every shape the card tests take
PLAN_SHAPES = sorted(set(CONV_SHAPES) | {(6, 100, 352, 64, 64),
                                         (6, 50, 176, 128, 128),
                                         (6, 25, 88, 256, 256)})


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,co", PLAN_SHAPES)
def test_tile_plan_covers_every_output_once(b, h, w, c, co, dtype, allmaps):
    """The blocks of the plan (the mapping conv3x3.cu computes from
    blockIdx) cover every (map, pixel, output channel) exactly once, and
    the plan fits one block's shared memory and an instantiation of its
    type."""
    plan = conv3x3_plan(b, h, w, c, co, dtype, allmaps)
    hits = np.zeros((b, h, w, co), np.int8)
    for maps, rows, cols, chans in plan.blocks(b):
        hits[maps.start:maps.stop, rows.start:rows.stop,
             cols.start:cols.stop, chans.start:chans.stop] += 1
    assert hits.min() == 1 and hits.max() == 1
    assert plan.smem_bytes <= SMEM_LIMIT
    if allmaps:  # K4b: one launch row, each block walks every map
        assert plan.grid[1] == 1 and plan.groups * plan.maps >= b
    else:  # K4a: the maps are on the grid
        assert plan.groups == 1 and plan.grid[1] * plan.maps >= b
    assert (plan.wgs, plan.mr, plan.block_n) in (
        KERNELS if dtype == torch.bfloat16 else F32_KERNELS)
    assert plan.maps * plan.tile_h * plan.tile_w == plan.wgs * plan.mr * 64
    assert plan.tile_w % 8 == 0 and plan.tile_h * plan.tile_w % 64 == 0
    assert plan.tile_w <= 256 and plan.tile_h + 2 <= 256
    assert plan.maps <= 256 and plan.a_stages >= 2 and plan.b_stages >= 2
    # the kernel's dynamic shared memory (conv3x3.cu:launch): per ring slot
    # one operand (bf16) or the tf32 big and small pair (f32)
    parts = 1 if dtype == torch.bfloat16 else 2
    assert plan.smem_bytes == parts * 128 * (
        plan.a_stages * plan.maps * (plan.tile_h + 2) * plan.tile_w
        + plan.b_stages * plan.block_n) + 16 * (
            plan.a_stages + plan.b_stages) + 1024


def test_tile_plan_instantiations_match_the_source():
    """``KERNELS`` and ``F32_KERNELS`` list exactly the instantiations
    conv3x3.cu compiles."""
    import os
    import re

    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "airv2x_tpu_torch", "csrc", "conv3x3.cu")
    with open(src) as f:
        text = f.read()
    for macro, kernels in (("CONV3X3_PLANS", KERNELS),
                           ("CONV3X3_F32_PLANS", F32_KERNELS)):
        block = text.split(f"#define {macro}(X)")[1].split("\n\n")[0]
        found = {tuple(int(v) for v in m)
                 for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", block)}
        assert found == set(kernels), macro


def test_tile_plan_reaches_every_instantiation():
    """The card tests' shapes run every instantiation of the kernel, bf16
    and f32."""
    for dtype, kernels in ((torch.bfloat16, KERNELS),
                           (torch.float32, F32_KERNELS)):
        picked = {(p.wgs, p.mr, p.block_n) for p in (
            conv3x3_plan(*shape, dtype, allmaps)
            for shape in PLAN_SHAPES for allmaps in (False, True))}
        assert picked == set(kernels), dtype


@pytest.mark.parametrize("b,h,w,c,co", [(6, 100, 352, 64, 64),
                                         (6, 50, 176, 128, 128),
                                         (6, 25, 88, 256, 256)])
def test_f32_plan_costs_more_than_bf16(b, h, w, c, co):
    """At the flagship stages the f32 plan models three tf32 products of
    half the rate, twice the slot bytes and the split: its modelled time
    lies between 2x and 8x the bf16 plan's, and its rings are no deeper."""
    from airv2x_tpu_torch.ops.conv3x3 import plan_cost

    for allmaps in (False, True):
        p16 = conv3x3_plan(b, h, w, c, co, torch.bfloat16, allmaps)
        p32 = conv3x3_plan(b, h, w, c, co, torch.float32, allmaps)
        t16 = plan_cost(p16, b, c, torch.bfloat16)
        t32 = plan_cost(p32, b, c, torch.float32)
        assert 2 * t16 < t32 < 8 * t16
        assert p32.a_stages <= p16.a_stages and p32.b_stages <= p16.b_stages


def test_bf16_plan_refuses_partial_m64_blocks():
    with pytest.raises(ValueError, match="m64"):
        make_plan(2, 8, 8, 64, False, 2, 12, 64, maps=1, wgs=1, mr=1)
    with pytest.raises(ValueError, match="m64"):  # 32 pixels per map
        make_plan(2, 8, 8, 64, True, 2, 16, 64, maps=2, wgs=1, mr=1)


def _tf32_cases():
    """f32 values: random normals over many scales, both signs, exact
    ties of the 13 dropped bits, zeros, subnormals, the largest finite."""
    rng = np.random.default_rng(14)
    v = (rng.standard_normal(4000) * 10.0 ** rng.uniform(-30, 30, 4000))
    bits = rng.integers(0, 2 ** 23, 64, dtype=np.int64)
    ties = ((127 << 23) | (bits & ~0x1FFF) | 0x1000).astype(np.int32)
    ties = ties.view(np.float32) * np.where(np.arange(64) % 2, -1.0, 1.0)
    special = [0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -3e-39,
               np.finfo(np.float32).max * 0.99, 1.0, -1.0]
    return np.concatenate([v, ties, special]).astype(np.float32)


def test_tf32_split_rounds_as_cvt_rna():
    """big is v rounded to 10 mantissa bits, to nearest with ties away from
    zero (cvt.rna.tf32.f32), its low 13 bits zero; small = tf32(v - big);
    big + small keeps v to 2^-21 relative (normal values), signs and zeros
    keep their sign, subnormals split exactly as their bits say."""
    v = _tf32_cases()
    big, small = (t.numpy() for t in tf32_split(torch.from_numpy(v)))
    for part in (big, small):
        assert (part.view(np.int32) & 0x1FFF == 0).all()
    # the reference rounding on the magnitude in float64: to nearest on
    # the 2^-10 grid of the value's binade, ties away from zero
    mag = np.abs(v.astype(np.float64))
    exp = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = 2.0 ** (np.maximum(exp, -126) - 10)
    want = np.floor(mag / ulp + 0.5) * ulp * np.sign(v)
    np.testing.assert_array_equal(big.astype(np.float64), want)
    assert (np.signbit(big) == np.signbit(v)).all()
    normal = mag >= np.finfo(np.float32).tiny * 2 ** 12
    rel = np.abs((big.astype(np.float64) + small) - v) / np.where(
        normal, mag, 1.0)
    assert rel[normal].max() <= 2.0 ** -21
    ties = v[4000:4064]
    assert (np.abs(tf32_split(torch.from_numpy(ties))[0].numpy())
            > np.abs(ties)).all()  # a tie rounds away from zero


def test_pack_f32_weights_layout():
    """(2, Cout, 9, Cin): tap-major HWIO taps, Cin innermost; part 0 + part
    1 gives back the weights to 2^-21 relative."""
    w = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (3, 3, 8, 16)).astype(np.float32))
    packed = pack_f32_weights(w)
    assert packed.shape == (2, 16, 9, 8) and packed.is_contiguous()
    back = (packed[0].double() + packed[1].double()).reshape(16, 3, 3, 8)
    want = w.double().permute(3, 0, 1, 2)
    assert float(((back - want).abs() / want.abs()).max()) <= 2.0 ** -21
    assert torch.equal(packed[0], tf32_split(w)[0].permute(3, 0, 1, 2)
                       .reshape(16, 9, 8))
