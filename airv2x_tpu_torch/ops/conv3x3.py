"""K4, the 3x3 stride-1 SAME conv with a fused affine + ReLU epilogue:
kernel wrapper, its plain PyTorch version, the im2col form and the support
gates (counterpart of airv2x_tpu/ops/pallas_conv.py).

Layouts follow the JAX package: x NHWC, w HWIO, output NHWC in x's dtype.
The CUDA kernel is ``csrc/conv3x3.cu``; its note says what bounds it and
how it is laid out. ``allmaps=True`` (K4b) computes the same function with
every map in one block's loop instead of a grid over maps (K4a).
``conv3x3_plan`` picks the kernel's tiles and grid for a shape; in f32 the
kernel reads the weights repacked as ``pack_f32_weights`` makes them.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from airv2x_tpu_torch import kernels

# The gates keep the JAX package's estimate of the TPU kernel's VMEM use
# (pallas_conv.py:53-66, :128-144) against its 100 MiB budget, so both
# packages accept and refuse the same shapes. The budget is the TPU's; the
# CUDA kernel itself only needs channels that are multiples of 8.
VMEM_BUDGET = 100 * 1024 * 1024


def _itemsize(dtype) -> int:
    return dtype.itemsize


def _padded_w(w: int, dtype) -> int:
    t = 32 // _itemsize(dtype)  # the TPU's sublane tile: f32 8, bf16 16
    return -(-w // t) * t


def grid_block_bytes(shape, dtype, features: int) -> int:
    """The grid-over-maps form's block estimate, in bytes, for NHWC
    ``shape`` -> ``features`` channels in ``dtype``, which its gate holds
    against ``VMEM_BUDGET``."""
    _, h, w, c = shape
    item = _itemsize(dtype)
    wp = _padded_w(w, dtype)
    xblk = (h + 2) * wp * 3 * c * item
    oblk = h * wp * features * item
    acc = h * wp * features * 4
    return 2 * xblk + 2 * oblk + acc + 3 * 3 * c * features * item


def supports_conv3x3(shape, dtype, features: int) -> bool:
    """Whether the grid-over-maps kernel takes NHWC ``shape`` -> ``features``
    channels in ``dtype`` (the JAX ``supports_pallas_conv3x3``)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % 8 or features % 8 or h < 2 or w < 2:
        return False
    return grid_block_bytes(shape, dtype, features) <= VMEM_BUDGET


def supports_conv3x3_allmaps(shape, dtype, features: int) -> bool:
    """The same gate for the all-maps form, which holds every map at once
    (the JAX ``supports_pallas_conv3x3_allmaps``)."""
    if len(shape) != 4:
        return False
    b, h, w, c = shape
    if c % 8 or features % 8 or h < 2 or w < 2:
        return False
    item = _itemsize(dtype)
    wp = _padded_w(w, dtype)
    est = (
        b * (h + 2) * wp * 3 * c * item
        + b * h * wp * features * item
        + h * wp * features * 4
        + 3 * 3 * c * features * item
    )
    return est <= VMEM_BUDGET


# The card the tile plan fills (an H100 SXM's 132 SMs) and the shared memory
# one block may use there.
SMS = 132
SMEM_LIMIT = 232448
# The kernel's A ring holds per slot one box of maps x (tile_h + 2) x tile_w
# pixels of one 128-byte row of channels (64 bf16, 32 f32) each, its B ring
# per slot block_n / 64 weight boxes of 64 rows x 128 bytes; an f32 slot
# holds two of each (tf32 big and small). It aligns the rings to 1024 bytes
# and keeps two 8-byte mbarriers per slot after them.
_ROW_BYTES = 128
_RINGS = ((2, 4), (2, 3), (2, 2))  # (A, B) depths: the deepest that fits
# conv3x3.cu's instantiations: (warpgroups, m64 blocks per warpgroup,
# block_n), at most 128 f32 accumulators per thread; the ones the plan picks
# at some shape (no 256-wide N: it never wins under the plan's model, and
# the sweep measured it slower than two 128-wide N tiles at stage 2).
# bf16 (CONV3X3_PLANS) and f32 (CONV3X3_F32_PLANS) apart: an f32 slot pair
# is twice the bytes, so three warpgroups of two m64 blocks never fit, and
# f32 holds a second set of accumulators (each tap's partial), so at most
# 64 of each per thread.
KERNELS = ((1, 1, 64), (1, 2, 64), (2, 2, 64), (2, 2, 128), (3, 1, 64),
           (3, 1, 128), (3, 2, 64))
F32_KERNELS = ((1, 1, 64), (1, 2, 64), (2, 1, 128), (2, 2, 64))
_TILE_WIDTHS = (8, 16, 32, 64, 128, 256)  # a multiple of 8 pixels


@dataclass(frozen=True)
class ConvPlan:
    """How one ``conv3x3_same`` launch covers (B, H, W, Cout).

    A block computes ``maps`` consecutive maps x ``tile_h`` x ``tile_w``
    pixels (M, the map outermost; ``wgs`` warpgroups of ``mr`` m64 blocks
    each) by ``block_n`` output channels, for ``groups`` consecutive groups
    of maps, through an A ring of ``a_stages`` and a B ring of ``b_stages``
    slots. Block ``(gx, gy)`` of ``grid`` takes spatial tile
    ``gx // n_tiles`` (row major over ``tiles_x`` columns of tiles), output
    channels from ``(gx % n_tiles) * block_n`` and maps from
    ``gy * groups * maps``. K4a has ``groups = 1``, so the maps are on the
    grid; K4b has one row of blocks, each walking every map."""

    tile_h: int
    tile_w: int
    maps: int
    wgs: int
    mr: int
    block_n: int
    a_stages: int
    b_stages: int
    tiles_x: int
    tiles_y: int
    n_tiles: int
    groups: int
    grid: tuple
    smem_bytes: int

    @property
    def n_blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def blocks(self, b: int):
        """(maps, rows, columns, output channels) of every block, as ranges
        that may run past the map: the kernel masks them."""
        per = self.groups * self.maps
        for gy in range(self.grid[1]):
            for tile in range(self.tiles_x * self.tiles_y):
                for nt in range(self.n_tiles):
                    y0 = tile // self.tiles_x * self.tile_h
                    x0 = tile % self.tiles_x * self.tile_w
                    yield (range(gy * per, min(b, (gy + 1) * per)),
                           range(y0, y0 + self.tile_h),
                           range(x0, x0 + self.tile_w),
                           range(nt * self.block_n,
                                 (nt + 1) * self.block_n))


def make_plan(b, h, w, cout, allmaps, tile_h, tile_w, block_n, *, maps,
              wgs, mr, dtype=torch.bfloat16) -> ConvPlan:
    """The plan of the given tiles (``conv3x3_plan`` picks them), with the
    deepest rings of ``_RINGS`` that fit."""
    m = maps * tile_h * tile_w
    if wgs * mr * 64 != m or tile_w % 8 or tile_h * tile_w % 64:
        raise ValueError(f"{maps} x {tile_h} x {tile_w} pixels is not "
                         f"{wgs} x {mr} m64 blocks of whole maps")
    parts = 1 if dtype == torch.bfloat16 else 2  # f32: tf32 big and small
    slot_a = parts * maps * (tile_h + 2) * tile_w * _ROW_BYTES
    slot_b = parts * block_n * _ROW_BYTES

    def smem(ring):
        return ring[0] * slot_a + ring[1] * slot_b + 16 * sum(ring) + 1024

    fits = [r for r in _RINGS if smem(r) <= SMEM_LIMIT]
    rings = fits[0] if fits else _RINGS[-1]
    tiles_x, tiles_y = -(-w // tile_w), -(-h // tile_h)
    n_tiles = -(-cout // block_n)
    n_groups = -(-b // maps)
    groups = n_groups if allmaps else 1
    return ConvPlan(tile_h, tile_w, maps, wgs, mr, block_n, rings[0],
                    rings[1], tiles_x, tiles_y, n_tiles, groups,
                    (tiles_x * tiles_y * n_tiles, 1 if allmaps else n_groups),
                    smem(rings))


# The plan's time model: a block pulls its A and B boxes from L2, writes
# them to shared memory, and its wgmma reads A (64 rows x 32 bytes) and B
# (32 bytes x block_n) from shared memory for every product of 32 bytes of
# K (m64nNk16 bf16, m64nNk8 tf32, three of them per step in f32); in f32
# the consumers also read each A slot once and write it twice (the split);
# the three add up. Rates of one H100: the bf16 and TF32 tensor-core peaks,
# shared memory at 128 bytes per clock on each of 132 SMs at ~1.75 GHz,
# and an L2 rate fitted to the tile sweep (tools/conv3x3_sweep.py;
# PERF.md), like the mild penalty for a grid that leaves SMs idle (bf16).
# f32, fitted to the f32 sweep (PERF.md): the largest of the three
# (they overlap), at L2 and shared-memory rates of their own, plus a drain
# of the wgmma pipeline per tap of each block (the tap's partial is added
# into the sum, conv3x3.cu), over whole waves of blocks (the slot pairs
# leave room for one block per SM). It reads 1.6-1.9x the measured times
# and ranks the swept plans to within 5% of the fastest.
L2_BYTES_PER_S = 5.5e12
SMEM_BYTES_PER_S = 30e12
F32_L2_BYTES_PER_S = 3e12
F32_SMEM_BYTES_PER_S = 15e12
TAP_DRAIN_S = 0.4e-6
SM_SMEM = 233472  # shared memory of one SM (228 KiB)
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def plan_cost(plan: ConvPlan, b: int, c: int, dtype=torch.bfloat16) -> float:
    """Modelled seconds of one launch of ``plan`` on (b, ..., c) input."""
    bf16 = dtype == torch.bfloat16
    parts, products = (1, 1) if bf16 else (2, 3)
    chunk = _ROW_BYTES // (2 if bf16 else 4)  # channels per 128-byte row
    chunks = -(-c // chunk)
    m = plan.maps * plan.tile_h * plan.tile_w
    steps = plan.n_blocks * plan.groups * chunks
    box_a = plan.maps * (plan.tile_h + 2) * plan.tile_w * _ROW_BYTES
    # per chunk: three A boxes (the tile's rows and the halo rows, one per
    # column shift) and nine taps' weight boxes (f32: big and small)
    l2 = steps * (3 * box_a + 9 * parts * plan.block_n * _ROW_BYTES)
    # per chunk and tap: 4 K steps of `products` wgmmas on each m64 block
    wgmmas = steps * 9 * 4 * products * (m // 64)
    ops = wgmmas * 64 * plan.block_n * chunk // 4 * 2
    smem = l2 + wgmmas * (2048 + 32 * plan.block_n)
    if bf16:
        return ((l2 / L2_BYTES_PER_S + smem / SMEM_BYTES_PER_S
                 + ops / BF16_OPS_PER_S)
                * max(1.0, SMS / plan.n_blocks) ** 0.25)
    smem += steps * 3 * box_a * 3  # the split: one read, two writes
    t = (max(l2 / F32_L2_BYTES_PER_S, smem / F32_SMEM_BYTES_PER_S,
             ops / TF32_OPS_PER_S)
         + steps * 9 * TAP_DRAIN_S / min(plan.n_blocks, SMS))
    slots = SMS * max(1, SM_SMEM // plan.smem_bytes)
    return t * -(-plan.n_blocks // slots) * slots / plan.n_blocks


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b: int, h: int, w: int, c: int, cout: int, dtype,
                 allmaps: bool = False) -> ConvPlan:
    """The kernel's tiling of NHWC (b, h, w, c) -> cout in ``dtype``.

    Among the instantiations (``KERNELS`` in bf16, ``F32_KERNELS`` in f32)
    and the tile shapes whose pixels fill M with whole m64 blocks of one
    map each (K4a: one map per block; K4b: up to every map in one block),
    the plan ``plan_cost`` finds fastest, the less padded and then the
    wider on a tie.
    """
    best = None
    for wgs, mr, bn in KERNELS if dtype == torch.bfloat16 else F32_KERNELS:
        if bn > 64 and bn >= cout + 64:  # a whole N box of zeros
            continue
        m = wgs * mr * 64
        for maps in (range(1, min(b, m // 64) + 1) if allmaps else (1,)):
            pix = m // maps
            if m % maps or pix % 64:
                continue
            for tw in _TILE_WIDTHS:
                th = pix // tw
                if th < 1 or th > 254 or th * tw != pix:
                    continue
                plan = make_plan(b, h, w, cout, allmaps, th, tw, bn,
                                 maps=maps, wgs=wgs, mr=mr, dtype=dtype)
                if plan.smem_bytes > SMEM_LIMIT:
                    continue
                padded = (plan.tiles_y * th * plan.tiles_x * tw
                          * -(-b // maps) * maps)
                key = (plan_cost(plan, b, c, dtype), padded, -tw)
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]


def _tf32_rna(v):
    """f32 ``v`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does; the low 13 bits of the
    result are zero. Not finite values pass unchanged."""
    bits = (v.view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(v), bits.view(torch.float32), v)


def tf32_split(v):
    """(big, small) with big = tf32(v) and small = tf32(v - big): the 3xTF32
    split of f32 ``v`` (big + small keeps v to about 2^-21 relative)."""
    v = v.to(torch.float32).contiguous()
    big = _tf32_rna(v)
    return big, _tf32_rna(v - big)


def pack_f32_weights(w):
    """HWIO (3, 3, Cin, Cout) f32 weights as the f32 kernel reads them:
    (2, Cout, 9, Cin), the tf32 big part, then the small, Cin innermost
    (tf32 wgmma takes B only K-major)."""
    kh, kw, cin, cout = w.shape
    k_major = w.to(torch.float32).permute(3, 0, 1, 2).reshape(cout, 9, cin)
    return torch.stack(tf32_split(k_major))


def _epilogue(acc, scale, bias, relu: bool, dtype):
    """f32 ``acc * scale + bias``, ReLU, cast: the kernels' epilogue."""
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(dtype)


def conv3x3_same_plain(x, w, scale=None, bias=None, *, relu: bool = False):
    """Plain PyTorch version of ``conv3x3_same``: the operands (w first cast
    to x's dtype) widened to f32, one 3x3 SAME conv, the f32 epilogue, a
    cast to x's dtype. On a card, a caller that wants full f32 turns TF32
    off for cuDNN."""
    wc = w.to(x.dtype)
    acc = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   wc.permute(3, 2, 0, 1).float(), padding=1)
    return _epilogue(acc.permute(0, 2, 3, 1), scale, bias, relu, x.dtype)


def conv3x3_im2col(x, w, scale=None, bias=None, *, relu: bool = False):
    """The im2col form (pallas_conv.py:conv3x3_im2col, the XLA path there):
    (B*H*W, 9C) patches in (c, kh, kw) order times the (9C, Cout) weights,
    accumulated in f32 over x-dtype operands, then the same epilogue."""
    b, h, width, c = x.shape
    cout = w.shape[-1]
    patches = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)  # (B, 9C, HW)
    wf = w.to(x.dtype).permute(2, 0, 1, 3).reshape(9 * c, cout)
    acc = patches.transpose(1, 2).float() @ wf.float()  # (B, HW, Cout)
    return _epilogue(acc, scale, bias, relu, x.dtype).reshape(b, h, width, cout)


def _check(x, w, scale, bias):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv3x3_same: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} HWIO")
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cin != x.shape[-1]:
        raise ValueError(f"conv3x3_same: w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and t.numel() != cout:
            raise ValueError(f"conv3x3_same: {name} has {t.numel()} entries, "
                             f"Cout is {cout}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3x3_same: {name} is on {t.device}, x on "
                             f"{x.device}")


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernel's loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv3x3_same(x, w, scale=None, bias=None, *, relu: bool = False,
                 allmaps: bool = False, packed=None):
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC, with an optional fused
    per-channel f32 affine and ReLU (a folded eval BatchNorm).

    Equals ``relu?(conv(x, w) * scale + bias)`` with f32 accumulation over
    x-dtype operands; the output has x's dtype (float32 or bfloat16).

    A CPU tensor runs the plain version (as the JAX package's interpret
    mode does off the TPU); a CUDA tensor launches the kernel, K4b when
    ``allmaps``, else K4a. The kernel needs C and Cout multiples of 8.
    In f32 it reads the weights as ``pack_f32_weights(w)``: ``packed``
    passes that repacked split (a caller caches it per weight version),
    else it is made on every call.
    """
    _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, scale, bias, relu=relu)
    return _launch(x, w, scale, bias, relu, allmaps, None, packed)


def _launch(x, w, scale, bias, relu, allmaps, plan, packed=None):
    """Launch the kernel on CUDA tensors with ``plan`` (None: the tile plan
    of the shape); ``packed`` as ``conv3x3_same`` takes it."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3_same: dtype {x.dtype} unsupported")
    b, h, width, c = x.shape
    cout = w.shape[-1]
    if c % 8 or cout % 8:
        raise ValueError(f"conv3x3_same: the kernel needs channels that are "
                         f"multiples of 8, got {c} -> {cout}")
    x = _aligned(x)
    if x.dtype == torch.bfloat16:
        wc = _aligned(w.to(x.dtype))
    else:
        if packed is None:
            packed = pack_f32_weights(w)
        if (tuple(packed.shape) != (2, cout, 9, c)
                or packed.dtype != torch.float32
                or packed.device != x.device):
            raise ValueError(f"conv3x3_same: packed weights "
                             f"{tuple(packed.shape)} {packed.dtype} on "
                             f"{packed.device} are not (2, {cout}, 9, {c}) "
                             f"float32 on {x.device}")
        wc = _aligned(packed)
    f32 = dict(dtype=torch.float32, device=x.device)
    scale = (torch.ones(cout, **f32) if scale is None
             else _aligned(scale.to(torch.float32).reshape(cout)))
    bias = (torch.zeros(cout, **f32) if bias is None
            else _aligned(bias.to(torch.float32).reshape(cout)))
    out = torch.empty((b, h, width, cout), dtype=x.dtype, device=x.device)
    if plan is None:
        plan = conv3x3_plan(b, h, width, c, cout, x.dtype, allmaps)
    dev = x.device.index
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        err = kernels.lib("conv3x3").conv3x3(
            x.data_ptr(), wc.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, width, c, cout, int(relu), int(allmaps),
            int(x.dtype == torch.bfloat16), plan.tile_h, plan.tile_w,
            plan.maps, plan.wgs, plan.mr, plan.block_n, plan.a_stages,
            plan.b_stages, kernels.current_stream(),
        )
    kernels.check("conv3x3", err)
    kernels.LAUNCHES["conv3x3_allmaps" if allmaps else "conv3x3"] += 1
    return out
