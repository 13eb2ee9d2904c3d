"""K4, the 3x3 stride-1 SAME conv with a fused affine + ReLU epilogue:
kernel wrapper, its plain PyTorch version, the im2col form and the support
gates (counterpart of airv2x_tpu/ops/pallas_conv.py).

Layouts follow the JAX package: x NHWC, w HWIO, output NHWC in x's dtype.
The CUDA kernel is ``csrc/conv3x3.cu``; its note says what bounds it and
how it is laid out. ``allmaps=True`` (K4b) computes the same function with
every map in one block's loop instead of a grid over maps (K4a).
``conv3x3_plan`` picks the kernel's tiles and grid for a shape.
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
_VMEM_BUDGET = 100 * 1024 * 1024


def _itemsize(dtype) -> int:
    return dtype.itemsize


def _padded_w(w: int, dtype) -> int:
    t = 32 // _itemsize(dtype)  # the TPU's sublane tile: f32 8, bf16 16
    return -(-w // t) * t


def supports_conv3x3(shape, dtype, features: int) -> bool:
    """Whether the grid-over-maps kernel takes NHWC ``shape`` -> ``features``
    channels in ``dtype`` (the JAX ``supports_pallas_conv3x3``)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % 8 or features % 8 or h < 2 or w < 2:
        return False
    item = _itemsize(dtype)
    wp = _padded_w(w, dtype)
    xblk = (h + 2) * wp * 3 * c * item
    oblk = h * wp * features * item
    acc = h * wp * features * 4
    est = 2 * xblk + 2 * oblk + acc + 3 * 3 * c * features * item
    return est <= _VMEM_BUDGET


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
    return est <= _VMEM_BUDGET


# The card the tile plan fills (an H100 SXM's 132 SMs) and the shared memory
# one block may use there.
SMS = 132
SMEM_LIMIT = 232448
# bf16: the kernel's A ring holds per slot one box of maps x (tile_h + 2)
# x tile_w pixels of 64 channels (128 bytes each), its B ring per slot
# block_n / 64 weight boxes of 64 rows x 128 bytes; it aligns the rings to
# 1024 bytes and keeps two 8-byte mbarriers per slot after them.
_ROW_BYTES = 128
_RINGS = ((2, 4), (2, 3), (2, 2))  # (A, B) depths: the deepest that fits
# conv3x3.cu's instantiations: (warpgroups, m64 blocks per warpgroup,
# block_n), at most 128 f32 accumulators per thread; the ones the plan picks
# at some shape (no 256-wide N: it never wins under the plan's model, and
# the sweep measured it slower than two 128-wide N tiles at stage 2)
KERNELS = ((1, 1, 64), (1, 2, 64), (2, 2, 64), (2, 2, 128), (3, 1, 64),
           (3, 1, 128), (3, 2, 64))
_TILE_WIDTHS = (8, 16, 32, 64, 128, 256)  # a multiple of 8 pixels
# f32: conv3x3.cu's fixed FMA tiling (kTH x kTW pixels, kTN outputs, an
# (8 + 2) x (16 + 2) x 8 halo and 9 x 8 x 64 weights of f32 in static smem)
_F32_TILE = (8, 16, 64)
_F32_SMEM = (10 * 18 + 9 * 64) * 8 * 4


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
    grid; K4b has one row of blocks, each walking every map. The f32 kernel
    has its fixed tiling (``maps = 1``, its 3-D grid given by block count)."""

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


def bf16_plan(b, h, w, cout, allmaps, tile_h, tile_w, block_n, *, maps,
              wgs, mr) -> ConvPlan:
    """The bf16 plan of the given tiles (``conv3x3_plan`` picks them), with
    the deepest rings of ``_RINGS`` that fit."""
    m = maps * tile_h * tile_w
    if wgs * mr * 64 != m or tile_w % 8 or tile_h * tile_w % 64:
        raise ValueError(f"{maps} x {tile_h} x {tile_w} pixels is not "
                         f"{wgs} x {mr} m64 blocks of whole maps")
    slot_a = maps * (tile_h + 2) * tile_w * _ROW_BYTES
    slot_b = block_n * _ROW_BYTES

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
# them to shared memory, and its wgmma reads A (64 x 16) and B (16 x
# block_n) from shared memory for every m64nNk16 product; the three add up.
# Rates of one H100: the bf16 tensor-core peak, shared memory at 128 bytes
# per clock on each of 132 SMs at ~1.75 GHz, and an L2 rate fitted to the
# tile sweep (tools/conv3x3_sweep.py; PERF.md), like the mild penalty
# for a grid that leaves SMs idle.
L2_BYTES_PER_S = 5.5e12
SMEM_BYTES_PER_S = 30e12
BF16_OPS_PER_S = 989e12


def plan_cost(plan: ConvPlan, b: int, c: int) -> float:
    """Modelled seconds of one launch of ``plan`` on (b, ..., c) input."""
    chunks = -(-c // 64)
    m = plan.maps * plan.tile_h * plan.tile_w
    # per 64-channel chunk: three A boxes (the tile's rows and the halo
    # rows, one per column shift) and nine taps' weight boxes
    l2 = plan.n_blocks * plan.groups * chunks * _ROW_BYTES * (
        3 * plan.maps * (plan.tile_h + 2) * plan.tile_w + 9 * plan.block_n)
    ops = plan.n_blocks * plan.groups * m * plan.block_n * 9 * chunks * 64 * 2
    smem = l2 + ops * (2048 + 32 * plan.block_n) / (2048 * plan.block_n)
    return ((l2 / L2_BYTES_PER_S + smem / SMEM_BYTES_PER_S
             + ops / BF16_OPS_PER_S) * max(1.0, SMS / plan.n_blocks) ** 0.25)


@functools.lru_cache(maxsize=256)
def conv3x3_plan(b: int, h: int, w: int, c: int, cout: int, dtype,
                 allmaps: bool = False) -> ConvPlan:
    """The kernel's tiling of NHWC (b, h, w, c) -> cout in ``dtype``.

    bf16: among the instantiations (``KERNELS``) and the tile shapes whose
    pixels fill M with whole m64 blocks of one map each (K4a: one map per
    block; K4b: up to every map in one block), the plan ``plan_cost``
    finds fastest, the less padded and then the wider on a tie.
    """
    if dtype != torch.bfloat16:
        th, tw, tn = _F32_TILE
        tx, ty, nt = -(-w // tw), -(-h // th), -(-cout // tn)
        groups = b if allmaps else 1
        return ConvPlan(th, tw, 1, 2, 1, tn, 1, 1, tx, ty, nt, groups,
                        (tx * ty * nt, 1 if allmaps else b), _F32_SMEM)
    best = None
    for wgs, mr, bn in KERNELS:
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
                plan = bf16_plan(b, h, w, cout, allmaps, th, tw, bn,
                                 maps=maps, wgs=wgs, mr=mr)
                if plan.smem_bytes > SMEM_LIMIT:
                    continue
                padded = (plan.tiles_y * th * plan.tiles_x * tw
                          * -(-b // maps) * maps)
                key = (plan_cost(plan, b, c), padded, -tw)
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]


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
                 allmaps: bool = False):
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC, with an optional fused
    per-channel f32 affine and ReLU (a folded eval BatchNorm).

    Equals ``relu?(conv(x, w) * scale + bias)`` with f32 accumulation over
    x-dtype operands; the output has x's dtype (float32 or bfloat16).

    A CPU tensor runs the plain version (as the JAX package's interpret
    mode does off the TPU); a CUDA tensor launches the kernel, K4b when
    ``allmaps``, else K4a. The kernel needs C and Cout multiples of 8.
    """
    _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, scale, bias, relu=relu)
    return _launch(x, w, scale, bias, relu, allmaps, None)


def _launch(x, w, scale, bias, relu, allmaps, plan):
    """Launch the kernel on CUDA tensors with ``plan`` (None: the tile plan
    of the shape)."""
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
    wc = _aligned(w.to(x.dtype))
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
