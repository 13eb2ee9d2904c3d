"""Drive the PyTorch port's flagship path on one NVIDIA card and hold each
of its CUDA kernels against the kernel's plain PyTorch version.

    python3 chip_smoke.py

Phases; a failure in any of them ends the run with a non-zero exit code:

  1. the card's name and power limit; build the kernels (one nvcc per
     source, all started together) and print the build seconds;
  2. K1, the pillar encode, against its plain version at the flagship
     vehicle call (3 maps x 20,000 points of ``make_scene``, 704 x 200 grid,
     C = 64), f32 with TF32 off; CUDA-event times of both;
  3. K2, the rotated-quad IoU, against its plain version at 512 x 512, full
     and triangular, on the corners of decoded boxes around the scene's
     objects plus random quads; times of both;
  4. the tiny config on the card against the same weights on the CPU
     (the plain versions, which the CPU tests hold against the JAX package);
  5. the full flagship Where2comm path (vehicle 3 / rsu 2 / drone 1,
     20,000 points per agent, bf16, seeded random weights, top_k 512) on
     8 scenes, timed 3 times after a warm-up: forward, decode and rotated
     NMS per scene; median ms/scene and scenes/s, median per-stage ms, peak
     memory, kept detections, NMS passes, and the kernels' launch counts
     during the timed runs (K1 3x, K2 1x per scene);
  6. a torch.profiler window over 3 more scenes: device time by kernel and
     the device's idle share, with the SM clock and power draw after it.

It then prints the kernels' JSON line and, last, the device JSON line.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/where2comm.yaml")
TINY = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
NUM_AGENTS = {"vehicle": 3, "rsu": 2, "drone": 1}
POINTS_PER_AGENT = 20000
N_SCENES = 8
N_RUNS = 3  # timed runs over the scenes
TOP_K = 512
STAGES = ("encoder", "backbone+shrink+psm head", "fusion+heads", "decode+NMS")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core f32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per (i, j) pair in csrc/quad_iou.cu, counted from the
# source on its cheapest (entering) branch, a division counted as one:
# centring 16, two signed areas 32, signs / abs / tolerance 9, two clip sums
# of 4 edges x (5 + 4 half-planes x 17 + 9) = 656, the IoU 9.
K2_OPS_PER_PAIR = 722

K1_TOL = 1e-4  # f32: only the order of the atomic residual sums differs
K1_TOL_BF16 = 1e-2  # bf16 output: one bf16 rounding of values up to ~10
K2_TOL = 2e-5  # as tests/test_pallas_iou.py
TINY_TOL = 1e-4  # whole-model outputs through ~40 conv layers, f32


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def phase_build():
    from airv2x_tpu_torch import kernels

    print(smi("name,power.limit"))
    print(f"device {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(logs)}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line:
                print(f"  {name}: {line.strip()}")


def flagship_setup():
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = load_yaml(FLAGSHIP)
    hypes["model"]["args"]["max_cav"] = dict(NUM_AGENTS)
    hypes["train_params"]["max_cav"] = dict(NUM_AGENTS)
    model = init_random_(build_model(hypes, device="cuda"), seed=0)
    rng = np.random.default_rng(0)
    scenes, gts = [], []
    for _ in range(N_SCENES):
        b, gt = make_scene(rng, model.layout, num_objects=12,
                           num_agents=NUM_AGENTS,
                           points_per_agent=POINTS_PER_AGENT,
                           lidar_range=hypes["preprocess"]["cav_lidar_range"],
                           pts_per_box=100)
        scenes.append(batch_to_torch({k: v[None] for k, v in b.items()}, "cuda"))
        gts.append(gt)
    return hypes, model, scenes, gts


def phase_k1(model, scene):
    from airv2x_tpu_torch.ops.pillar_encode import (
        pillar_encode, pillar_encode_plain)

    set_tf32(False)
    enc = model.encoder.vehicle_pillar_vfe  # f32 weights at this point
    sl = model.layout.slots("vehicle")
    with torch.inference_mode():
        ids, feat, aux, params, kw = enc.kernel_inputs(
            scene["points"][:, sl], scene["points_mask"][:, sl])
    m, n = ids.shape
    c, cells = feat.shape[-1], kw["cells"]
    assert (m, n, c, cells) == (3, POINTS_PER_AGENT, 64, 140800), (m, n, c, cells)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        kw["out_dtype"] = dt
        got = pillar_encode(ids, feat, aux, params, **kw)
        ref = pillar_encode_plain(ids, feat, aux, params, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        tol = K1_TOL if dt == torch.float32 else K1_TOL_BF16
        occupied = int((aux[..., 0] > 0).sum())
        print(f"phase 2 K1 out {dt}: max|kernel - plain| = {err:.3e} "
              f"(tol {tol}); {occupied} valid points, "
              f"{int((got.float().abs().sum(-1) > 0).sum())} non-zero cells")
        if not err <= tol:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        ms = cuda_ms(lambda: pillar_encode(ids, feat, aux, params, **kw), 50)
        plain_ms = cuda_ms(
            lambda: pillar_encode_plain(ids, feat, aux, params, **kw), 10)
        out_bytes = m * cells * c * torch.empty((), dtype=dt).element_size()
        in_bytes = sum(t.numel() * t.element_size()
                       for t in (ids, feat, aux, params))
        bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        print(f"phase 2 K1 out {dt}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {bound_ms:.4f} ms (bytes: {in_bytes} in + "
              f"{out_bytes} out)")
        res[dt] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
    return res


def k2_quads(hypes, gts):
    """Corners of decoded boxes around the scenes' objects, plus random
    quads: 512 rows, overlapping in clusters as NMS candidates do."""
    from airv2x_tpu_torch.ops import geometry as geo
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
    from airv2x_tpu_torch.ops.boxes import decode_boxes

    rng = np.random.default_rng(1)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    lr = hypes["preprocess"]["cav_lidar_range"]
    h, w = anchors.shape[:2]
    centres = np.concatenate([g["boxes"][g["mask"]][:, :2] for g in gts])
    rows = []
    for cx, cy in centres:  # anchors at and around each object
        iy = int(np.clip((cy - lr[1]) / (lr[4] - lr[1]) * h, 0, h - 1))
        ix = int(np.clip((cx - lr[0]) / (lr[3] - lr[0]) * w, 0, w - 1))
        for dy, dx in ((0, 0), (0, 1), (1, 0)):
            rows.append(anchors[min(iy + dy, h - 1), min(ix + dx, w - 1)])
    anc = np.concatenate(rows)[:400]
    deltas = rng.normal(0, 0.05, anc.shape).astype(np.float32)
    boxes = decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anc))
    rand = np.stack([
        rng.uniform(lr[0], lr[3], 512), rng.uniform(lr[1], lr[4], 512),
        np.full(512, -1.0), rng.uniform(1.4, 1.8, 512),
        rng.uniform(1.5, 1.9, 512), rng.uniform(3.5, 4.5, 512),
        rng.uniform(-np.pi, np.pi, 512)], -1).astype(np.float32)
    boxes = torch.cat([boxes, torch.from_numpy(rand)])[:TOP_K]
    boxes[1] = boxes[0]  # an identical pair
    quads = geo.boxes_to_corners_3d(boxes)[:, :4, :2].contiguous()
    return quads[torch.from_numpy(rng.permutation(TOP_K))].contiguous().cuda()


def phase_k2(hypes, gts):
    from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain

    q = k2_quads(hypes, gts)
    ref = quad_iou_plain(q, q)
    full = quad_iou(q, q)
    tri = quad_iou(q, q, triangular=True)
    torch.cuda.synchronize()
    iu = torch.triu_indices(TOP_K, TOP_K, offset=1, device=q.device)
    err_full = float((full - ref).abs().max())
    err_tri = float((tri - ref)[iu[0], iu[1]].abs().max())
    overl = int((ref[iu[0], iu[1]] > 0).sum())
    print(f"phase 3 K2: max|kernel - plain| full {err_full:.3e}, triangular "
          f"(i < j) {err_tri:.3e} (tol {K2_TOL}); {overl} overlapping pairs "
          f"of {iu.shape[1]}")
    err = max(err_full, err_tri)
    if not err <= K2_TOL:
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    ms = cuda_ms(lambda: quad_iou(q, q, triangular=True), 200)
    ms_full = cuda_ms(lambda: quad_iou(q, q), 200)
    plain_ms = cuda_ms(lambda: quad_iou_plain(q, q), 20)
    pairs = TOP_K * (TOP_K - 1) // 2  # the upper triangle NMS reads
    ops_ms = pairs * K2_OPS_PER_PAIR / F32_OPS_PER_S * 1e3
    bytes_ms = (2 * q.numel() * 4 + TOP_K * TOP_K * 4) / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    print(f"phase 3 K2: kernel triangular {ms:.4f} ms, full {ms_full:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms (operations "
          f"{ops_ms:.5f} ms, bytes {bytes_ms:.5f} ms)")
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def phase_tiny():
    """The tiny config on the card against the same weights on the CPU."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.utils.weights import init_random_

    set_tf32(False)
    hypes = load_yaml(TINY)
    outs = {}
    b, _ = make_scene(np.random.default_rng(2),
                      SlotLayout.from_args(hypes["model"]["args"]),
                      num_objects=6, points_per_agent=2048, pts_per_box=60,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"])
    for dev in ("cpu", "cuda"):
        model = init_random_(build_model(hypes, device=dev), seed=3)
        with torch.inference_mode():
            outs[dev] = model(batch_to_torch({k: v[None] for k, v in b.items()},
                                             dev))
    errs = {}
    for k in ("psm", "rm", "obj", "comm_rate"):
        got, want = outs["cuda"][k].cpu().double(), outs["cpu"][k].double()
        errs[k] = float((got - want).abs().max())
        lim = TINY_TOL * (1 + float(want.abs().max()))
        if not (torch.isfinite(got).all() and errs[k] <= lim):
            raise AssertionError(f"tiny {k}: card vs CPU {errs[k]} > {lim}")
    print(f"phase 4 tiny model card vs CPU: max abs err {errs} "
          f"(tol {TINY_TOL} x (1 + scale))")


def phase_flagship(hypes, model, scenes):
    from airv2x_tpu_torch import kernels
    from airv2x_tpu_torch.data.postprocess import decode_detections
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid

    set_tf32(False)
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's defaults for bf16
    torch.backends.cudnn.benchmark = True  # fixed shapes: pick conv algos once
    model = model.to(torch.bfloat16)
    anchors = torch.from_numpy(
        generate_anchor_grid(hypes["postprocess"]["anchor_args"])).cuda()
    lidar_range = torch.tensor(hypes["preprocess"]["cav_lidar_range"],
                               dtype=torch.float32, device="cuda")
    eye = torch.eye(4, device="cuda")
    tgt = hypes["postprocess"]["target_args"]

    def run(batch, ev, host):
        """One scene; ``ev`` gets the device-side stage boundaries, ``host``
        the host clock at the same points (launch time, no sync)."""
        with torch.inference_mode():
            host.append(time.perf_counter())
            ev[0].record()
            x = model.encode(batch)
            ev[1].record()
            host.append(time.perf_counter())
            psm = model.single_psm(x)
            ev[2].record()
            host.append(time.perf_counter())
            out = model.fuse(x, psm, batch["agent_mask"])
            ev[3].record()
            host.append(time.perf_counter())
            det = decode_detections(
                out["psm"][0], out["rm"][0], out["obj"][0], anchors, eye,
                lidar_range, num_class=hypes["num_class"],
                obj_threshold=tgt["obj_threshold"],
                nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=TOP_K)
            ev[4].record()
            host.append(time.perf_counter())
        return out, det

    def events():
        return [torch.cuda.Event(enable_timing=True) for _ in range(5)]

    for batch in scenes:  # warm-up: allocator, cuDNN algorithm choice
        run(batch, events(), [])
    torch.cuda.synchronize()

    # the same scenes N_RUNS times: the host's noise shows as the spread
    torch.cuda.reset_peak_memory_stats()
    evs = [events() for _ in range(N_RUNS * len(scenes))]
    hosts = [[] for _ in evs]
    run_ms = []
    kernels.reset_launch_counts()
    for r in range(N_RUNS):
        mine = range(r * len(scenes), (r + 1) * len(scenes))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [run(scenes[i - mine.start], evs[i], hosts[i]) for i in mine]
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) / len(scenes) * 1e3)
        if r == 0:
            results = outs  # checked below
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    stage_ms = {s: statistics.median(ev[i].elapsed_time(ev[i + 1]) for ev in evs)
                for i, s in enumerate(STAGES)}
    host_ms = {s: statistics.median(h[i + 1] - h[i] for h in hosts) * 1e3
               for i, s in enumerate(STAGES)}
    ms = statistics.median(run_ms)
    print(f"phase 5 flagship: {ms:.3f} ms/scene, {1e3 / ms:.3f} scenes/s "
          f"(median of {N_RUNS} runs of {len(scenes)} scenes; ms/scene of each "
          f"run {[round(r, 3) for r in run_ms]})")
    print(f"phase 5 stage ms/scene, median of {len(evs)} scenes, device clock: "
          + json.dumps({k: round(v, 4) for k, v in stage_ms.items()}))
    print("phase 5 stage ms/scene, median, host clock (launch, no sync): "
          + json.dumps({k: round(v, 4) for k, v in host_ms.items()}))
    print(f"phase 5 peak memory {peak / 2**20:.1f} MiB")

    h, w = anchors.shape[:2]
    kept, passes, rates = [], [], []
    for out, det in results:
        assert tuple(out["psm"].shape) == (1, h, w, 14), out["psm"].shape
        assert tuple(out["rm"].shape) == (1, h, w, 14), out["rm"].shape
        assert tuple(out["obj"].shape) == (1, h, w, 2), out["obj"].shape
        for k in ("psm", "rm", "obj"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k}")
        rate = float(out["comm_rate"])
        if not 0.0 <= rate <= 1.0:
            raise AssertionError(f"comm_rate {rate}")
        if not bool(torch.isfinite(det.boxes[det.mask]).all()):
            raise AssertionError("non-finite kept boxes")
        kept.append(int(det.mask.sum()))
        passes.append(det.nms_passes)
        rates.append(round(rate, 4))
    print(f"phase 5 kept detections per scene {kept}; NMS passes per scene "
          f"{passes}; comm_rate per scene {rates}")
    print(f"phase 5 launches during the timed runs: {launches}")
    n = N_RUNS * len(scenes)
    want = {"pillar_encode": 3 * n, "quad_iou": n}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not any(kept):
        raise AssertionError("no detection survived decode")
    return launches, run, events


def phase_profile(run, events, scenes):
    """Device time by kernel over a few scenes of the main path, and the
    device's idle share of that window (torch.profiler / CUPTI)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = 3
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in scenes[:n]:
            run(batch, events(), [])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels, memcpy and memset
            continue
        # per scene; the attribute's name differs between releases
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / n, e.count / n, e.key))
    busy = sum(r[0] for r in rows)
    if not busy:
        print("phase 6 profile: no device time recorded (not measured)")
        return
    print(f"phase 6 profile over {n} scenes: device busy {busy:.3f} ms/scene "
          f"of {wall_ms / n:.3f} ms/scene wall under the profiler, idle share "
          f"{1 - busy / (wall_ms / n):.3f}")
    for ms, count, name in sorted(rows, reverse=True)[:15]:
        print(f"  {ms:8.4f} ms/scene {count:6.1f}x/scene  {name[:100]}")
    print(f"phase 6 clocks.sm, power.draw: {smi('clocks.sm,power.draw')}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    phase_build()
    hypes, model, scenes, gts = flagship_setup()
    k1 = phase_k1(model, scenes[0])
    k2 = phase_k2(hypes, gts)
    phase_tiny()
    launches, run, events = phase_flagship(hypes, model, scenes)
    phase_profile(run, events, scenes)
    k1_main = k1[torch.bfloat16]  # the main path writes bf16
    print(json.dumps({"kernels": [
        {"name": "pillar_encode", "route": "cuda",
         "source": "airv2x_tpu_torch/csrc/pillar_encode.cu",
         "replaces": "airv2x_tpu/ops/pallas_pillars.py:203",
         "launches": launches["pillar_encode"],
         "max_abs_err": k1[torch.float32]["err"], "ms": k1_main["ms"],
         "plain_ms": k1_main["plain_ms"], "bound_ms": k1_main["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "quad_iou", "route": "cuda",
         "source": "airv2x_tpu_torch/csrc/quad_iou.cu",
         "replaces": "airv2x_tpu/ops/pallas_iou.py:60",
         "launches": launches["quad_iou"], "max_abs_err": k2["err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
