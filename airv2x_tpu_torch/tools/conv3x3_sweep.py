"""Time the K4 kernel (``csrc/conv3x3.cu``) under many tile plans at the
flagship backbone's stage shapes, on one NVIDIA card.

    python -m airv2x_tpu_torch.tools.conv3x3_sweep [--dtype bf16|f32|both]
        [--out FILE]

For each type (bf16; f32, the 3xTF32 path), each stage (6 maps of
100x352x64, 50x176x128, 25x88x256, Cout = Cin) and each form (K4a, a grid
over maps; K4b, every map in one block's walk) it launches the kernel under
every plan of ``candidates`` (every instantiation of the type and maps per
block, the two least padded tile shapes of its M, the ring depths of
``RINGS`` that fit) and the plan ``conv3x3_plan`` picks, checks each result
against the plain version (bf16 2e-2 abs + rel; f32 1e-4 x (1 + scale),
TF32 off) and times it with CUDA events (the median of ``ROUNDS`` rounds
that take the plans in turn). It prints the fastest plans of each (type,
stage, form) beside the plan ``conv3x3_plan`` picks and the cuDNN conv + BN
+ ReLU of the ``auto`` ConvBNReLU, and writes every row as one JSON line to
``--out``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.ops import conv3x3
from airv2x_tpu_torch.ops.conv3x3 import (
    F32_KERNELS, KERNELS, SMEM_LIMIT, _launch, conv3x3_plan,
    conv3x3_same_plain, make_plan)

STAGES = ((6, 100, 352, 64), (6, 50, 176, 128), (6, 25, 88, 256))
WIDTHS = (8, 16, 32, 64, 128, 256)
RINGS = ((2, 2), (2, 3), (2, 4), (3, 4), (2, 6), (3, 6))  # (A, B) depths tried
ROUNDS = 5  # timing rounds over all plans, in turn; the median counts


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls. A spin
    kernel holds the card while the host enqueues the calls, so the events
    time the device's work and not the host's launch cost (which can exceed
    a short kernel's run time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda._sleep(int(2e9 * (1.5 * iters * host_s + 1e-3)))  # ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


DEFAULT_RINGS = conv3x3._RINGS


def candidates(shape, allmaps, dtype):
    """Every instantiation of ``dtype`` x maps per block (K4b) x the two
    least padded tile shapes of its M x the ring depths of ``RINGS`` that
    fit in shared memory."""
    b, h, w, c = shape
    out = []
    for wgs, mr, bn in KERNELS if dtype == torch.bfloat16 else F32_KERNELS:
        if bn > 64 and bn >= c + 64:
            continue
        m = wgs * mr * 64
        for maps in (range(1, min(b, m) + 1) if allmaps else (1,)):
            if m % maps:
                continue
            shapes = sorted(
                (-(-h // (m // maps // tw)) * (m // maps // tw)
                 * -(-w // tw) * tw, -tw, m // maps // tw, tw)
                for tw in WIDTHS if m // maps // tw >= 1
                and (m // maps // tw) * tw * maps == m
                and (m // maps) % 64 == 0)
            for _, _, th, tw in shapes[:2]:
                for rings in RINGS:
                    conv3x3._RINGS = (rings,)
                    p = make_plan(b, h, w, c, allmaps, th, tw, bn, maps=maps,
                                  wgs=wgs, mr=mr, dtype=dtype)
                    if p.smem_bytes <= SMEM_LIMIT:
                        out.append(p)
    conv3x3._RINGS = DEFAULT_RINGS
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "f32", "both"), default="both")
    ap.add_argument("--out", default="airv2x_tpu_torch/build/conv3x3_sweep.jsonl")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv3x3_sweep: no CUDA device is available")
    from airv2x_tpu_torch.models.nn import ConvBNReLU
    from airv2x_tpu_torch.utils.weights import cast_weights_, init_random_

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    kernels.lib("conv3x3")
    torch.backends.cudnn.benchmark = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dtypes = {"bf16": (torch.bfloat16,), "f32": (torch.float32,),
              "both": (torch.bfloat16, torch.float32)}[args.dtype]
    rng = np.random.default_rng(4)
    with open(args.out, "w") as f:
        for dt, (si, shape) in itertools.product(dtypes, enumerate(STAGES)):
            b, h, w, c = shape
            name = "bf16" if dt == torch.bfloat16 else "f32"
            blk = init_random_(ConvBNReLU(c, c), seed=10 + si).cuda().eval()
            blk.requires_grad_(False)
            cast_weights_(blk, dt)
            x = torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)).cuda().to(dt)
            wk, sc, bi, packed = blk._fold(dt)
            ref = conv3x3_same_plain(x, wk, sc, bi, relu=True).float()
            if dt == torch.bfloat16:
                lim = 2e-2 * (1 + ref.abs())
            else:
                lim = 1e-4 * (1 + float(ref.abs().max()))
            xl = x.permute(0, 3, 1, 2)
            os.environ["AIRV2X_CONV_KERNEL"] = "auto"
            with torch.inference_mode():
                lib_ms = cuda_ms(lambda: blk(xl))
            for allmaps in (False, True):
                chosen = conv3x3_plan(b, h, w, c, c, dt, allmaps)
                plans = candidates(shape, allmaps, dt)
                if chosen not in plans:
                    plans.append(chosen)
                oks = []
                for p in plans:
                    got = _launch(x, wk, sc, bi, True, allmaps, p, packed)
                    oks.append(bool(((got.float() - ref).abs() <= lim).all()))
                times = [[] for _ in plans]
                for _ in range(ROUNDS):
                    for i, p in enumerate(plans):
                        times[i].append(cuda_ms(lambda: _launch(
                            x, wk, sc, bi, True, allmaps, p, packed),
                            iters=10))
                rows = []
                for p, ok, ts in zip(plans, oks, times):
                    ms = statistics.median(ts)
                    row = dict(dtype=name, stage=si, allmaps=allmaps,
                               maps=p.maps, tile_h=p.tile_h, tile_w=p.tile_w,
                               wgs=p.wgs, mr=p.mr, block_n=p.block_n,
                               rings=[p.a_stages, p.b_stages],
                               blocks=p.n_blocks,
                               smem=p.smem_bytes, ok=ok, ms=ms,
                               lib_ms=lib_ms, chosen=p == chosen, card=card)
                    f.write(json.dumps(row) + "\n")
                    rows.append(row)
                rows.sort(key=lambda r: r["ms"])
                form = "K4b" if allmaps else "K4a"
                pick = [r for r in rows if r["chosen"]]
                print(f"{name} stage {si} {shape} {form}: library "
                      f"{lib_ms:.4f} ms; chosen {pick[0] if pick else None}")
                for r in rows[:10]:
                    print(f"  {r['ms']:.4f} ms  {r['maps']}x{r['tile_h']}x"
                          f"{r['tile_w']} wg{r['wgs']} mr{r['mr']} "
                          f"n{r['block_n']} rings {r['rings']} blocks "
                          f"{r['blocks']} smem {r['smem']} ok {r['ok']}")
                if not all(r["ok"] for r in rows):
                    raise AssertionError(f"a {name} plan disagrees at stage "
                                         f"{si}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
