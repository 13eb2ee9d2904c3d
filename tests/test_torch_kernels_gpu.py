"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips, from inside the
``cuda`` fixture, when no card is present. This file imports neither JAX
nor ``airv2x_tpu``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import copy
import importlib.util
import os

import numpy as np
import pytest
import torch

from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.ops.conv3x3 import conv3x3_same, conv3x3_same_plain
from airv2x_tpu_torch.ops.pillar_encode import pillar_encode, pillar_encode_plain
from airv2x_tpu_torch.ops.pillar_reduce import (
    FEAT, LANES, NEG, pillar_reduce, pillar_reduce_plain)
from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py as a module (its top level imports only numpy and
    torch), for the tiny V2X-ViT transformer it defines."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    kernels.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _encode_inputs(rng, m, n, c, cells):
    ids = rng.integers(-2, cells + 2, (m, n)).astype(np.int32)  # some skipped
    ids[:, :8] = cells // 2  # a hot cell
    feat = rng.normal(0, 3, (m, n, c)).astype(np.float32)
    feat[0, :4] = -0.0
    w = (rng.uniform(size=(m, n, 1)) > 0.1).astype(np.float32)
    aux = np.concatenate([w, rng.uniform(-0.2, 0.2, (m, n, 3)) * w], -1)
    params = rng.normal(0, 1, (7, c)).astype(np.float32)
    params[5] = np.where(rng.uniform(size=c) > 0.3, 1.0, -1.0)
    return ids, feat, aux.astype(np.float32), params


@pytest.mark.parametrize("c,out_dtype", [(64, torch.float32),
                                          (64, torch.bfloat16),
                                          (3, torch.float32)])
def test_pillar_encode_kernel_matches_plain(cuda, c, out_dtype):
    rng = np.random.default_rng(0)
    nx, ny, m, n = 704, 37, 3, 20000
    cells = nx * ny
    inputs = _encode_inputs(rng, m, n, c, cells)
    args = [torch.from_numpy(a).to(cuda) for a in inputs]
    kw = dict(cells=cells, nx=nx, out_dtype=out_dtype,
              grid_consts=(0.4, 0.4, -140.6, -7.2, -1.0))
    before = kernels.LAUNCHES["pillar_encode"]
    got = pillar_encode(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pillar_encode"] == before + 1
    ref = pillar_encode_plain(*args, **kw)
    assert got.shape == (m, cells, c) and got.dtype == out_dtype
    # residual sums are atomic adds in run-dependent order: a few f32 ulps
    _check_k1(got, ref, _occupied(inputs[0], cells), out_dtype)


def test_pillar_encode_kernel_empty_cloud(cuda):
    ids = torch.full((2, 64), 10, dtype=torch.int32, device=cuda)
    feat = torch.zeros((2, 64, 8), device=cuda)
    aux = torch.zeros((2, 64, 4), device=cuda)
    params = torch.ones((7, 8), device=cuda)
    out = pillar_encode(ids, feat, aux, params, cells=10, nx=5,
                        grid_consts=(1.0, 1.0, 0.5, 0.5, 0.0))
    assert out.shape == (2, 10, 8)
    assert float(out.abs().max()) == 0.0


FLAGSHIP_GRID = dict(nx=704, ny=200, consts=(0.4, 0.4, -140.6, -39.8, -1.0))


def _k1_case(kind, rng, c=64):
    """K1 inputs at the flagship vehicle call (3 maps x 20,000 slots, a
    704 x 200 grid) unless the case says otherwise:
      sparse      ~30% valid slots as in make_scene: a quarter of the slots
                  uniform ground points, ~1,000 points on 12 boxes, the rest
                  skipped;
      dense       every slot valid, ids uniform over the cells;
      hot         every point of a map in one cell;
      skipped     every id outside [0, cells);
      n_gt_cells  5,000 points on a 40 x 25 grid (5 per cell on average)."""
    nx, ny, m, n = FLAGSHIP_GRID["nx"], FLAGSHIP_GRID["ny"], 3, 20000
    if kind == "n_gt_cells":
        nx, ny, m, n = 40, 25, 2, 5000
    cells = nx * ny
    ids = np.full((m, n), cells, np.int32)
    if kind == "sparse":
        n_ground, n_box = n // 4, 12 * 90
        ids[:, :n_ground] = rng.integers(0, cells, (m, n_ground))
        centres = rng.integers(0, cells - 8 * nx - 8, (m, 12))
        offs = rng.integers(0, 8, (m, n_box)) * nx + rng.integers(0, 8, (m, n_box))
        ids[:, n_ground:n_ground + n_box] = (
            np.repeat(centres, 90, axis=1) + offs)
    elif kind in ("dense", "n_gt_cells"):
        ids[:] = rng.integers(0, cells, (m, n))
    elif kind == "hot":
        ids[:] = rng.integers(0, cells, (m, 1))
    else:  # skipped: below, at and past the cell range
        ids[:] = rng.choice(np.array([-5, -1, cells, cells + 7], np.int32),
                            (m, n))
    feat = rng.normal(0, 3, (m, n, c)).astype(np.float32)
    feat[0, :4] = -0.0
    valid = ((ids >= 0) & (ids < cells)).astype(np.float32)[..., None]
    aux = np.concatenate([valid, rng.uniform(-0.2, 0.2, (m, n, 3)) * valid], -1)
    params = rng.normal(0, 1, (7, c)).astype(np.float32)
    params[5] = np.where(rng.uniform(size=c) > 0.3, 1.0, -1.0)
    return (ids, feat, aux.astype(np.float32), params), dict(
        cells=cells, nx=nx, grid_consts=FLAGSHIP_GRID["consts"])


def _occupied(ids, cells):
    """(m, cells) bool: the cells that hold at least one point."""
    occ = np.zeros((ids.shape[0], cells), bool)
    for g, row in enumerate(ids):
        occ[g, row[(row >= 0) & (row < cells)]] = True
    return occ


def _check_k1(got, ref, occupied, out_dtype):
    """Within the f32 / bf16 tolerance of the plain version, and every
    empty cell holds +0.0 bits."""
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)
    bits = got.view(torch.int32 if out_dtype == torch.float32 else torch.int16)
    empty = torch.from_numpy(~occupied).to(got.device)
    assert int((bits[empty] != 0).sum()) == 0  # +0.0: value 0, sign bit clear


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["sparse", "dense", "hot", "skipped",
                                  "n_gt_cells"])
def test_pillar_encode_kernel_occupancy_cases(cuda, kind, out_dtype):
    inputs, kw = _k1_case(kind, np.random.default_rng(8))
    args = [torch.from_numpy(a).to(cuda) for a in inputs]
    kw["out_dtype"] = out_dtype
    before = kernels.LAUNCHES["pillar_encode"]
    got = pillar_encode(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pillar_encode"] == before + 1
    ref = pillar_encode_plain(*args, **kw)
    occupied = _occupied(inputs[0], kw["cells"])
    assert got.shape == ref.shape and got.dtype == out_dtype
    _check_k1(got, ref, occupied, out_dtype)
    if kind == "skipped":
        assert not occupied.any()
    else:
        assert float(got.float().abs().max()) > 0


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pillar_encode_kernel_fresh_inputs_back_to_back(cuda, out_dtype):
    """A dense call, then a sparse one of the same shapes with fresh
    tensors, both checked after the second: the workspace of the second
    call reuses the first's memory, so a cell -> leader table or a row left
    stale puts the first call's values into the second's empty cells."""
    rng = np.random.default_rng(9)
    cases = [_k1_case(kind, rng) for kind in ("dense", "sparse")]
    outs = []
    for inputs, kw in cases:
        args = [torch.from_numpy(a).to(cuda) for a in inputs]
        kw["out_dtype"] = out_dtype
        outs.append((pillar_encode(*args, **kw), args, kw))
    torch.cuda.synchronize()
    for (got, args, kw), (inputs, _) in zip(outs, cases):
        _check_k1(got, pillar_encode_plain(*args, **kw),
                  _occupied(inputs[0], kw["cells"]), out_dtype)


@pytest.mark.parametrize("kind", ["dense", "hot", "n_gt_cells"])
def test_pillar_encode_kernel_maxima_deterministic(cuda, kind):
    """With W_cl = 0 the output depends on the maxima and the counts alone
    (the means enter only through W_cl . mean), and both are exact in any
    order of the atomics: repeated calls give the same bits."""
    inputs, kw = _k1_case(kind, np.random.default_rng(10))
    inputs[3][0:3] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in inputs]
    first = pillar_encode(*args, **kw)
    again = [pillar_encode(*args, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    for other in again:
        assert torch.equal(first.view(torch.int32), other.view(torch.int32))
    _check_k1(first, pillar_encode_plain(*args, **kw),
              _occupied(inputs[0], kw["cells"]), torch.float32)


def _quads(rng, n):
    xy = np.stack([rng.uniform(-60, 60, n), rng.uniform(-30, 30, n)], -1)
    lw = np.stack([rng.uniform(3.5, 4.5, n), rng.uniform(1.5, 1.9, n)], -1)
    yaw = rng.uniform(-np.pi, np.pi, n)
    tmpl = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) * 0.5
    local = tmpl[None] * lw[:, None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    x = c * local[..., 0] - s * local[..., 1] + xy[:, None, 0]
    y = s * local[..., 0] + c * local[..., 1] + xy[:, None, 1]
    return np.stack([x, y], -1).astype(np.float32)


@pytest.mark.parametrize("n,m", [(512, 512), (300, 200)])
def test_quad_iou_kernel_matches_plain(cuda, n, m):
    rng = np.random.default_rng(1)
    q1 = _quads(rng, n)
    q1[1::7] = q1[0::7][: len(q1[1::7])]  # duplicates
    q1[:50, :, 0] *= 0.05  # crowd some quads together so they overlap
    q2 = q1[:m].copy()
    a, b = torch.from_numpy(q1).to(cuda), torch.from_numpy(q2).to(cuda)
    ref = quad_iou_plain(a, b)
    full = quad_iou(a, b)
    tri = quad_iou(a, b, triangular=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(full, ref, atol=2e-5, rtol=0)
    iu = torch.triu_indices(n, m, offset=1, device=cuda)
    torch.testing.assert_close(tri[iu[0], iu[1]], ref[iu[0], iu[1]],
                               atol=2e-5, rtol=0)
    assert float((full > 0).float().mean()) > 0.001  # overlaps exist


def test_quad_iou_kernel_exact_cases(cuda):
    sq = np.array([[0, 0], [4, 0], [4, 2], [0, 2]], np.float32) + 100.0
    shifted = sq + np.array([4, 0], np.float32)  # shares the edge x = 104
    rot = np.array([[0, 0], [2, 2], [0, 4], [-2, 2]], np.float32) - 70.0
    q = torch.from_numpy(np.stack([sq, sq, shifted, rot, rot])).to(cuda)
    iou = quad_iou(q, q).cpu().numpy()
    assert iou[0, 1] == pytest.approx(1.0, abs=1e-6)
    assert iou[3, 4] == pytest.approx(1.0, abs=1e-6)
    assert abs(iou[0, 2]) <= 1e-6 and abs(iou[1, 2]) <= 1e-6
    np.testing.assert_allclose(np.diag(iou), 1.0, atol=1e-6)


@pytest.mark.parametrize("n,m", [(512, 300), (37, 300), (129, 5), (1, 7)])
def test_quad_iou_kernel_ap_shapes(cuda, n, m):
    """The full (rectangular) mode at the AP's shapes: kept detections x
    ground truth, ragged against the tile, with degenerate detections (a
    zero-width box, a point, a sliver), whose IoU is 0."""
    rng = np.random.default_rng(5)
    gt = _quads(rng, m)
    det = gt[rng.integers(0, m, n)] + rng.normal(0, 0.3, (n, 1, 2)).astype(np.float32)
    det[(n + 1) // 2:] = _quads(rng, n - (n + 1) // 2)
    if n > 3:
        det[0, 2], det[0, 3] = det[0, 1], det[0, 0]
        det[1] = det[1, :1]
        det[2, 3], det[2, 2] = det[2, 0] + 3e-6, det[2, 1] + 3e-6
    a, b = torch.from_numpy(det).to(cuda), torch.from_numpy(gt).to(cuda)
    before = kernels.LAUNCHES["quad_iou"]
    got = quad_iou(a, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quad_iou"] == before + 1
    ref = quad_iou_plain(a, b)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=0)
    if n > 3:
        assert bool((got[:3] == 0).all())
    assert float((ref > 0.3).float().mean()) > 0  # matches exist


def test_dataset_batch_through_tiny_model_on_card_matches_cpu(cuda, tmp_path):
    """One batch of an on-disk scenario (chip_smoke.py's writer) loaded for
    the card and for the CPU (the same arrays; the anchor targets within
    one f32 rounding of the card's math library), then through the tiny
    model in f32 on both (TF32 off, pinned cuDNN)."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    cs = _chip_smoke()
    hypes = load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml"))
    model = init_random_(build_model(hypes, device="cpu"), seed=3)
    cs.write_scenario(str(tmp_path), model.layout,
                      hypes["preprocess"]["cav_lidar_range"], stamps=2,
                      num_agents={"vehicle": 2, "rsu": 1, "drone": 1},
                      points_per_agent=2048)
    ds = AirV2XDataset(hypes, str(tmp_path), train=False)
    batches = {d: next(RealDataLoader(ds, hypes, 2, train=False, num_workers=1,
                                      device=d).batches()) for d in ("cpu", cuda)}
    errs = cs.same_batch(batches[cuda], batches["cpu"])
    assert all(v <= (cs.BATCH_TARGET_TOL if k == "labels.targets" else 0.0)
               for k, v in errs.items()), errs
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        outs = {}
        for d, m in (("cpu", model), (cuda, copy.deepcopy(model).to(cuda))):
            batch = {k: v for k, v in batches[d].items() if k != "labels"}
            with torch.inference_mode():
                outs[d] = m(batch)
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    for k in ("psm", "rm", "obj"):
        scale = float(outs["cpu"][k].abs().max())
        torch.testing.assert_close(outs[cuda][k].cpu(), outs["cpu"][k],
                                   atol=1e-4 * (1 + scale), rtol=0)


def test_camera_batch_through_tiny_model_on_card_matches_cpu(cuda, tmp_path):
    """One batch of an on-disk scenario with cameras (chip_smoke.py's writer,
    72 x 128 images, the AirV2X augmentation keys) loaded for the card and
    for the CPU (every camera array equal), then through the tiny
    camera-only model in f32 on both (TF32 off, pinned cuDNN; the card
    fuses with the CPU's confidence). The grid moves by
    ``chip_smoke.GRID_SHIFT``: the writer's symmetric rig puts frustum
    points on the unshifted grid's cell boundaries, where the card and the
    CPU could round a point into neighbouring cells; no K1 launch."""
    from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
    from airv2x_tpu_torch.data.loader import RealDataLoader
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    cs = _chip_smoke()
    hypes = cs.shift_camera_grid(cs.tiny_camera_hypes("cam"))
    for t in ("vehicle", "rsu", "drone"):
        hypes["model"]["args"][t]["cam"]["data_aug_conf"].update(
            dict(cs.AIRV2X_AUG, H=72, W=128))
    model = init_random_(build_model(hypes, device="cpu"), seed=3)
    cs.write_scenario(str(tmp_path), model.layout,
                      hypes["preprocess"]["cav_lidar_range"], stamps=2,
                      num_agents={"vehicle": 2, "rsu": 1, "drone": 1},
                      points_per_agent=500, camera_hw=(72, 128))
    ds = AirV2XDataset(hypes, str(tmp_path), train=False)
    batches = {d: next(RealDataLoader(ds, hypes, 2, train=False, num_workers=1,
                                      device=d).batches()) for d in ("cpu", cuda)}
    errs = cs.same_batch(batches[cuda], batches["cpu"])
    assert sum(k.startswith("cam_") for k in errs) == 18
    assert all(v <= (cs.BATCH_TARGET_TOL if k == "labels.targets" else 0.0)
               for k, v in errs.items()), errs
    for i in range(len(ds)):
        sample = {k: ({kk: vv[None] for kk, vv in v.items()}
                      if isinstance(v, dict) else v[None])
                  for k, v in ds[i][0].items()}
        assert cs.camera_frustum_margin(hypes, sample) > cs.CELL_MARGIN
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        outs = {}
        for d, m in (("cpu", model), (cuda, copy.deepcopy(model).to(cuda))):
            batch = {k: v for k, v in batches[d].items() if k != "labels"}
            kernels.reset_launch_counts()
            with torch.inference_mode():
                x = m.encode(batch)
                single = m.single_psm(x)
                conf = single if d == "cpu" else outs["cpu"]["single"].to(d)
                outs[d] = dict(m.fuse(x, conf, batch["agent_mask"]), single=single)
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    assert kernels.LAUNCHES["pillar_encode"] == 0
    for k in ("single", "psm", "rm", "obj"):
        scale = float(outs["cpu"][k].abs().max())
        torch.testing.assert_close(outs[cuda][k].cpu(), outs["cpu"][k],
                                   atol=1e-4 * (1 + scale), rtol=0)


def test_tiny_model_on_card_matches_cpu(cuda):
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.postprocess import decode_detections
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_scene
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.anchors import generate_anchor_grid
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml"))
    models = {d: init_random_(build_model(hypes, device=d), seed=3)
              for d in ("cpu", "cuda")}
    b, _ = make_scene(np.random.default_rng(2), models["cpu"].layout,
                      num_objects=6, points_per_agent=2048, pts_per_box=60,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"])
    batch = {k: v[None] for k, v in b.items()}
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    outs, dets = {}, {}
    kernels.reset_launch_counts()
    for d, model in models.items():
        with torch.inference_mode():
            out = model(batch_to_torch(batch, d))
            lr = torch.tensor(hypes["preprocess"]["cav_lidar_range"], device=d)
            dets[d] = decode_detections(
                out["psm"][0], out["rm"][0], out["obj"][0],
                torch.from_numpy(anchors).to(d), torch.eye(4, device=d), lr,
                num_class=hypes["num_class"], obj_threshold=0.2,
                nms_thresh=hypes["postprocess"]["nms_thresh"], top_k=256)
        outs[d] = out
    torch.cuda.synchronize()
    # the card ran its kernels: one K1 per agent type, one K2
    assert kernels.LAUNCHES == {"pillar_encode": 3, "quad_iou": 1,
                                "pillar_reduce": 0, "conv3x3": 0,
                                "conv3x3_allmaps": 0}
    for k in ("psm", "rm", "obj", "comm_rate"):
        torch.testing.assert_close(outs["cuda"][k].cpu(), outs["cpu"][k],
                                   atol=1e-4, rtol=1e-4)
    assert int(dets["cuda"].mask.sum()) > 0


@pytest.mark.parametrize("m,n,cells", [(3, 20000, 140800), (2, 137, 50)])
def test_pillar_reduce_kernel_matches_plain(cuda, m, n, cells):
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cells + 1, (m, n)).astype(np.int32)  # incl. dump
    ids[:, :16] = cells // 3  # a hot cell
    vals = rng.normal(size=(m, n, LANES)).astype(np.float32)
    vals[..., :FEAT] = np.where(rng.uniform(size=(m, n, 1)) > 0.2,
                                vals[..., :FEAT], NEG)
    vals[0, :4, :FEAT] = -0.0
    ids_t, vals_t = torch.from_numpy(ids).to(cuda), torch.from_numpy(vals).to(cuda)
    before = kernels.LAUNCHES["pillar_reduce"]
    got = pillar_reduce(ids_t, vals_t, cells)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pillar_reduce"] == before + 1
    ref = pillar_reduce_plain(ids_t, vals_t, cells)
    assert got.shape == (m, cells + 8, LANES)
    assert torch.equal(got[..., :FEAT], ref[..., :FEAT])  # maxima are exact
    # the sums: atomic adds in run-dependent order
    torch.testing.assert_close(got[..., FEAT:], ref[..., FEAT:], atol=1e-4,
                               rtol=1e-4)


# the flagship backbone's stage shapes (6 maps), ragged edges, Cout < 64,
# and the edges of the bf16 tiling: Cin = 8 and 24 (one 64-channel box,
# zero past Cin), Cin = 72 (a second, mostly empty box), Cout = 8 and 24
# (below the 64-wide N tile), Cout = 264 (a second N tile), H = 2 and W = 2
# (the gate's minimum), W one past a tile width (65, 129), B = 1, and B = 5,
# whose last group of maps in a K4b block is partial; with the flagship
# stages they reach every instantiation of the bf16 kernel
CONV_SHAPES = [(6, 100, 352, 64, 64), (6, 50, 176, 128, 128),
               (6, 25, 88, 256, 256), (3, 13, 22, 8, 8), (2, 9, 17, 16, 24),
               (1, 2, 2, 8, 8), (2, 2, 65, 24, 24), (1, 7, 129, 8, 16),
               (3, 33, 2, 24, 8), (1, 5, 65, 72, 264), (2, 10, 129, 64, 128),
               (2, 33, 129, 24, 136), (5, 9, 40, 64, 64)]


def _conv_inputs(rng, b, h, w, c, co, dtype, device):
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    k = torch.from_numpy((rng.normal(size=(3, 3, c, co))
                          * np.sqrt(2 / (9 * c))).astype(np.float32))
    s = torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.2, co).astype(np.float32))
    return (x.to(device, dtype), k.to(device, dtype), s.to(device),
            bias.to(device))


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,c,co", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda, b, h, w, c, co, dtype, allmaps):
    x, k, s, bias = _conv_inputs(np.random.default_rng(5), b, h, w, c, co,
                                 dtype, cuda)
    key = "conv3x3_allmaps" if allmaps else "conv3x3"
    before = kernels.LAUNCHES[key]
    got = conv3x3_same(x, k, s, bias, relu=True, allmaps=allmaps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[key] == before + 1
    ref = conv3x3_same_plain(x, k, s, bias, relu=True)
    assert got.shape == (b, h, w, co) and got.dtype == dtype
    if dtype == torch.float32:  # f32 sums in another order, no TF32
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=1e-4 * (1 + scale), rtol=0)
    else:  # one bf16 rounding of the output, as tests/test_pallas_conv.py
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    nobias = conv3x3_same(x, k, allmaps=allmaps)
    torch.testing.assert_close(nobias.float(), conv3x3_same_plain(x, k).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_conv3x3_kernel_fresh_inputs_back_to_back(cuda, allmaps):
    """Two inputs of one shape, one call each, then both checked: a result
    that follows the first call's tensor (a stale tensor map, a reused
    buffer) fails the second check."""
    rng = np.random.default_rng(6)
    shape = (2, 25, 88, 64, 128)
    x1, k, s, bias = _conv_inputs(rng, *shape, torch.bfloat16, cuda)
    x2 = _conv_inputs(rng, *shape, torch.bfloat16, cuda)[0]
    got1 = conv3x3_same(x1, k, s, bias, relu=True, allmaps=allmaps)
    got2 = conv3x3_same(x2, k, s, bias, relu=True, allmaps=allmaps)
    torch.cuda.synchronize()
    for x, got in ((x1, got1), (x2, got2)):
        ref = conv3x3_same_plain(x, k, s, bias, relu=True)
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2,
                                   rtol=2e-2)
    assert not torch.equal(got1, got2)


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_conv3x3_kernel_is_deterministic(cuda, allmaps):
    """The bf16 kernel has no atomics: the same inputs give the same bits."""
    x, k, s, bias = _conv_inputs(np.random.default_rng(7), 6, 25, 88, 256,
                                 256, torch.bfloat16, cuda)
    first = conv3x3_same(x, k, s, bias, relu=True, allmaps=allmaps)
    second = conv3x3_same(x, k, s, bias, relu=True, allmaps=allmaps)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_conv3x3_f32_kernel_fresh_inputs_back_to_back(cuda, allmaps):
    """The 3xTF32 path: two inputs of one shape, one call each, then both
    checked at the f32 tolerance; the second call takes the repacked split
    weights as ``ConvBNReLU`` caches them, the first repacks them itself."""
    from airv2x_tpu_torch.ops.conv3x3 import pack_f32_weights

    rng = np.random.default_rng(11)
    shape = (2, 25, 88, 64, 128)
    x1, k, s, bias = _conv_inputs(rng, *shape, torch.float32, cuda)
    x2 = _conv_inputs(rng, *shape, torch.float32, cuda)[0]
    got1 = conv3x3_same(x1, k, s, bias, relu=True, allmaps=allmaps)
    got2 = conv3x3_same(x2, k, s, bias, relu=True, allmaps=allmaps,
                        packed=pack_f32_weights(k))
    torch.cuda.synchronize()
    for x, got in ((x1, got1), (x2, got2)):
        ref = conv3x3_same_plain(x, k, s, bias, relu=True)
        scale = float(ref.abs().max())
        torch.testing.assert_close(got, ref, atol=1e-4 * (1 + scale), rtol=0)
    assert not torch.equal(got1, got2)


@pytest.mark.parametrize("allmaps", [False, True], ids=["grid", "allmaps"])
def test_conv3x3_f32_kernel_is_deterministic(cuda, allmaps):
    """The 3xTF32 path has no atomics either: the same bits twice."""
    x, k, s, bias = _conv_inputs(np.random.default_rng(12), 6, 25, 88, 256,
                                 256, torch.float32, cuda)
    first = conv3x3_same(x, k, s, bias, relu=True, allmaps=allmaps)
    second = conv3x3_same(x, k, s, bias, relu=True, allmaps=allmaps)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def _k2_case(kind, rng, n, m):
    """(n, 4, 2) and (m, 4, 2) quads for K2's prefilter:
      overlap    every quad around one point: every pair needs the clip;
      separated  quads on a 10 m grid: the prefilter rejects every pair
                 but the diagonal;
      clustered  an NMS pool: jittered copies around a few objects;
      nan        random quads with NaN rows and an infinite corner."""
    if kind == "overlap":
        q = _quads(rng, max(n, m))
        q -= q.mean(1, keepdims=True)
        q += rng.normal(0, 0.3, (len(q), 1, 2)).astype(np.float32)
    elif kind == "separated":
        q = _quads(rng, max(n, m))
        q -= q.mean(1, keepdims=True)
        side = int(np.ceil(np.sqrt(len(q))))
        cell = np.arange(len(q))
        q[..., 0] += 10.0 * (cell % side)[:, None] - 70.0
        q[..., 1] += 10.0 * (cell // side)[:, None] - 30.0
    elif kind == "clustered":
        q = _quads(rng, max(n, m))
        centres = q[rng.integers(0, 6, len(q))].mean(1, keepdims=True)
        q += centres - q.mean(1, keepdims=True) + rng.normal(
            0, 0.5, (len(q), 1, 2)).astype(np.float32)
    else:
        q = _quads(rng, max(n, m, 8))
        q[3::17, 1, 0] = np.nan
        q[5] = np.nan
        q[7, 2, 1] = np.inf
    q = q.astype(np.float32)
    return q[:n], q[rng.permutation(len(q))[:m]]


@pytest.mark.parametrize("triangular", [False, True], ids=["full", "tri"])
@pytest.mark.parametrize("kind,n,m", [
    ("overlap", 96, 96), ("separated", 512, 512), ("clustered", 512, 512),
    ("clustered", 77, 141), ("nan", 200, 200), ("nan", 1, 1),
    ("overlap", 1, 1), ("clustered", 33, 65)])
def test_quad_iou_kernel_prefilter_cases(cuda, kind, n, m, triangular):
    """Against the plain version, bit for bit on every pair the kernel must
    give (every pair in full mode, i < j in triangular mode), NaN where the
    plain version has NaN."""
    rng = np.random.default_rng(13)
    q1, q2 = _k2_case(kind, rng, n, m)
    if triangular:
        q2 = q1[:m] if m <= n else np.concatenate([q1, q2[n:]])
    a, b = torch.from_numpy(q1).to(cuda), torch.from_numpy(q2).to(cuda)
    before = kernels.LAUNCHES["quad_iou"]
    got = quad_iou(a, b, triangular=triangular)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["quad_iou"] == before + 1
    ref = quad_iou_plain(a, b)
    if triangular:
        iu = torch.triu_indices(n, m, offset=1, device=cuda)
        got, ref = got[iu[0], iu[1]], ref[iu[0], iu[1]]
    torch.testing.assert_close(got, ref, atol=0, rtol=0, equal_nan=True)
    if kind == "overlap" and n > 1:
        assert float((ref > 0).float().mean()) > 0.9
    if kind == "nan":
        assert bool(ref.isnan().any()) or n == 1


@pytest.mark.parametrize("triangular", [False, True], ids=["full", "tri"])
def test_quad_iou_kernel_no_rows(cuda, triangular):
    q = torch.from_numpy(_quads(np.random.default_rng(14), 4)).to(cuda)
    empty = q[:0].contiguous()
    assert quad_iou(empty, q, triangular=triangular).shape == (0, 4)
    assert quad_iou(q, empty, triangular=triangular).shape == (4, 0)
    torch.cuda.synchronize()


def _tiny_train(task, device):
    """The tiny config's trainable model (flax-like initialisation), its
    loss, optimizer, schedule and one labelled batch on ``device``."""
    import copy

    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch, make_batch
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.anchors import (
        anchor_standup_boxes, generate_anchor_grid)
    from airv2x_tpu_torch.parallel.train import make_optimizer
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    hypes = load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml"))
    if task == "seg":
        hypes = copy.deepcopy(hypes)
        hypes["task"] = hypes["model"]["args"]["task"] = "seg"
    model = init_flax_like_(build_model(hypes, device=device, train=True), 0)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    batch, _ = make_batch(
        np.random.default_rng(1), model.layout, 2, anchors=anchors,
        anchor_standup=anchor_standup_boxes(anchors),
        target_args=hypes["postprocess"]["target_args"],
        seg_hw=96 if task == "seg" else 0, device=device, num_objects=6,
        points_per_agent=1024, pts_per_box=60,
        lidar_range=hypes["preprocess"]["cav_lidar_range"],
        max_boxes=hypes["postprocess"]["max_num"])
    opt, sched = make_optimizer(hypes, model.parameters(), 10)
    return model, build_loss(hypes), opt, sched, batch_to_torch(batch, device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("task", ["det", "seg"])
def test_train_step_on_card(cuda, task, dtype):
    """Three train steps of the tiny model on the card (bf16: autocast over
    f32 master weights): finite loss parts and gradients, f32 parameters
    and Adam moments, BN statistics moved, and no kernel launched (the
    train path runs no TPU-kernel counterpart)."""
    from airv2x_tpu_torch.parallel.train import TrainState, make_train_step

    model, loss_fn, opt, sched, batch = _tiny_train(task, cuda)
    state = TrainState(model, opt)
    step = make_train_step(loss_fn, sched, compute_dtype=dtype, seed=1)
    bn = model.backbone.stages[0].layers[0].bn
    before = bn.running_mean.clone()
    kernels.reset_launch_counts()
    for _ in range(3):
        parts = step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in parts.values()), parts
        for name, p in model.named_parameters():
            assert p.dtype == torch.float32, name
            assert bool(torch.isfinite(p.grad).all()), name
    torch.cuda.synchronize()
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert not torch.equal(before, bn.running_mean)
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())


def _f64(tree):
    """A numpy batch with its floating arrays in float64."""
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and np.issubdtype(tree.dtype, np.floating):
        return tree.astype(np.float64)
    return tree


@pytest.mark.parametrize("name", ["airv2x_cobevt", "airv2x_v2vnet",
                                  "airv2x_when2com"])
def test_family_train_step_on_card_matches_cpu(cuda, name):
    """One train step of a tiny family model (chip_smoke.py's TINY_FAMILY,
    det) on the card, TF32 off and cuDNN pinned, against the same step on
    the CPU from the same weights and batch: the loss parts to 1e-5
    relative, every gradient within chip_smoke's STEP_GRAD_TOL of the
    leaf's scale plus STEP_GRAD_FLOOR of the largest, the updated BN
    statistics to 1e-5 x (1 + |v|); no kernel launched. When2com runs in
    float64 on both, its gradients held to WHEN2COM_F64_GRAD_TOL /
    WHEN2COM_F64_GRAD_FLOOR: in f32 its policy CNN's train-mode BNs
    amplify rounding past the f32 bounds (tests/test_torch_train_eager.py),
    and in float64 only its warp grid's f32 island remains."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import (
        batch_to_torch, make_batch, perturb_poses)
    from airv2x_tpu_torch.loss import build_loss
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.anchors import (
        anchor_standup_boxes, generate_anchor_grid)
    from airv2x_tpu_torch.parallel.train import (
        TrainState, make_optimizer, make_train_step)
    from airv2x_tpu_torch.utils.weights import init_flax_like_

    cs = _chip_smoke()
    hypes = cs.tiny_family_hypes(load_yaml(cs.TINY), name)
    double = name == "airv2x_when2com"
    tol, floor = ((cs.WHEN2COM_F64_GRAD_TOL, cs.WHEN2COM_F64_GRAD_FLOOR) if double
                  else (cs.STEP_GRAD_TOL, cs.STEP_GRAD_FLOOR))
    cudnn = torch.backends.cudnn
    flags = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        models = {"cpu": init_flax_like_(build_model(hypes, device="cpu",
                                                     train=True), 0)}
        models["cuda"] = build_model(hypes, device="cuda", train=True)
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
        batch, _ = make_batch(
            np.random.default_rng(1), models["cpu"].layout, 2, anchors=anchors,
            anchor_standup=anchor_standup_boxes(anchors),
            target_args=hypes["postprocess"]["target_args"], device="cpu",
            num_objects=6, points_per_agent=1024, pts_per_box=60,
            lidar_range=hypes["preprocess"]["cav_lidar_range"],
            max_boxes=hypes["postprocess"]["max_num"])
        batch = perturb_poses(batch, np.random.default_rng(cs.TINY_FAMILY_POSES))
        if double:
            for m in models.values():
                m.double()
            batch = _f64(batch)
        parts = {}
        kernels.reset_launch_counts()
        for dev, model in models.items():
            opt, sched = make_optimizer(hypes, model.parameters(), 10)
            step = make_train_step(build_loss(hypes), sched)
            parts[dev] = step(TrainState(model, opt), batch_to_torch(batch, dev))
        torch.cuda.synchronize()
        assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    finally:
        cudnn.benchmark, cudnn.deterministic = flags
    for k, v in parts["cpu"].items():
        assert float(parts["cuda"][k]) == pytest.approx(float(v), rel=1e-5), k
    cpu = dict(models["cpu"].named_parameters())
    top = max(float(p.grad.abs().max()) for p in cpu.values())
    for pname, p in models["cuda"].named_parameters():
        g, want = p.grad.cpu(), cpu[pname].grad
        bound = tol * float(want.abs().max()) + floor * top
        assert float((g - want).abs().max()) <= bound, pname
    bufs = dict(models["cpu"].named_buffers())
    for bname, b in models["cuda"].named_buffers():
        if bname.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(b.cpu(), bufs[bname], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["foreach", "fused"])
def test_fold_cache_after_training_on_card(cuda, impl, monkeypatch):
    """On the card: a train-mode forward bumps the BN statistics' versions,
    AdamW's foreach update the parameters' (its fused update need not:
    ``train()`` / ``eval()`` drop the fold cache), and the ``pallas`` eval
    after the update (K4a, f32) equals the cuDNN ``auto`` eval."""
    from airv2x_tpu_torch.models.nn import ConvBNReLU

    torch.manual_seed(0)
    blk = ConvBNReLU(64, 64).to(cuda).eval()
    x = torch.randn(2, 64, 20, 24, device=cuda)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    with torch.no_grad():
        blk(x)  # caches the fold

    def key():
        return [(t.data_ptr(), t._version) for t in (
            blk.conv.weight, blk.bn.weight, blk.bn.bias, blk.bn.running_mean,
            blk.bn.running_var)]

    k0 = key()
    blk.train()
    blk(x).square().mean().backward()
    k1 = key()
    assert k1[3] != k0[3] and k1[4] != k0[4]
    flags = dict(foreach=True) if impl == "foreach" else dict(fused=True)
    torch.optim.AdamW(blk.parameters(), lr=1e-2, weight_decay=1e-4, **flags).step()
    if impl == "foreach":
        assert all(a != b for a, b in zip(k1[:3], key()[:3]))
    blk.eval()
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = blk(x)
        monkeypatch.setenv("AIRV2X_CONV_KERNEL", "auto")
        want = blk(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["conv3x3"] == 1
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * (1 + scale)


# --- the camera-LSS path --------------------------------------------------------

# the camera block of tests/test_camera.py's tiny model
TINY_CAM = {
    "grid_conf": {"xbound": [-19.2, 19.2, 0.4], "ybound": [-19.2, 19.2, 0.4],
                  "zbound": [-10, 10, 20.0], "ddiscr": [2, 50, 8], "mode": "LID"},
    "data_aug_conf": {"final_dim": [64, 96]}, "img_downsample": 8,
    "img_features": 16, "bevout_feature": 16, "camera_encoder": "EfficientNet",
    "use_depth_gt": True, "depth_supervision": False,
}


def _tiny_camera(kind, device):
    """The model of the tiny config with cameras (``cam``: every type camera
    only, depth from the softmax head; ``lidar+cam``: the vehicles both, gt
    depth) with seeded random weights, and two scenes with camera inputs
    (the scenes of tests/test_torch_camera.py, whose frustum points lie
    more than 1e-4 of a cell from every cell boundary)."""
    import copy

    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import add_camera_inputs, make_scene
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = copy.deepcopy(load_yaml(os.path.join(
        REPO, "hypes_yaml/test/tiny_where2comm.yaml")))
    args = hypes["model"]["args"]
    for t in (("vehicle", "rsu", "drone") if kind == "cam" else ("vehicle",)):
        args[t]["modalities"] = ["cam"] if kind == "cam" else ["lidar", "cam"]
        args[t]["cam"] = dict(TINY_CAM, use_depth_gt=kind != "cam")
    model = init_random_(build_model(hypes, device=device), seed=3)
    rng = np.random.default_rng(3)
    scenes = []
    for na in ({"vehicle": 2, "rsu": 1, "drone": 1},
               {"vehicle": 2, "rsu": 1, "drone": 0}):
        b, _ = make_scene(rng, model.layout, num_objects=6, points_per_agent=1024,
                          lidar_range=hypes["preprocess"]["cav_lidar_range"],
                          pts_per_box=60, num_agents=na)
        add_camera_inputs(b, model.layout, rng, img_hw=(64, 96),
                          ncam={"vehicle": 2, "rsu": 1, "drone": 1})
        scenes.append(b)
    batch = {k: ({kk: np.stack([s[k][kk] for s in scenes]) for kk in scenes[0][k]}
                 if isinstance(scenes[0][k], dict)
                 else np.stack([s[k] for s in scenes])) for k in scenes[0]}
    return model, batch


@pytest.mark.parametrize("kind", ["cam", "lidar+cam"])
def test_tiny_camera_model_on_card_matches_cpu(cuda, kind):
    """f32, TF32 off, deterministic cuDNN: the card's single-agent
    confidence and fused outputs (fused with the CPU's confidence, so the
    comm mask is the same) within 1e-4 x (1 + scale) of the CPU's; K1 runs
    once per LiDAR type, never for a camera-only type."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch

    torch.backends.cudnn.deterministic = True
    try:
        outs = {}
        for d in ("cpu", "cuda"):
            model, batch = _tiny_camera(kind, d)
            tb = batch_to_torch(batch, d)
            kernels.reset_launch_counts()
            with torch.inference_mode():
                x = model.encode(tb)
                psm = model.single_psm(x)
                use = psm if d == "cpu" else outs["cpu"]["single"].to(d)
                out = model.fuse(x, use, tb["agent_mask"])
            torch.cuda.synchronize()
            outs[d] = {"single": psm, **out}
            launches = dict(kernels.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = False
    assert launches["pillar_encode"] == (0 if kind == "cam" else 3), launches
    for k in ("single", "psm", "rm", "obj", "comm_rate"):
        want, got = outs["cpu"][k].double(), outs["cuda"][k].cpu().double()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert err <= 1e-4 * (1 + scale), (k, err, scale)


def test_voxel_pooling_full_width_bf16_on_card(cuda):
    """One full-width vehicle call of ``voxel_pooling`` (3 agents x 6
    cameras x 8 depths x 32 x 44 lifted points, 64 channels, the 704 x 200
    grid) in bf16 on the card against the f32 sum of the same bf16 values:
    bf16 accumulation rounds each add (unit roundoff u = 2^-8), so a cell of
    n points lies within (n - 1) u sum|x| of the exact sum, plus the
    final rounding."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import add_camera_inputs
    from airv2x_tpu_torch.models.base import SlotLayout
    from airv2x_tpu_torch.models.camera.lss import (
        create_frustum, gen_dx_bx, get_geometry, voxel_pooling)

    cfg = load_yaml(os.path.join(REPO, "hypes_yaml/airv2x/camera/det/where2comm.yaml"))[
        "model"]["args"]["vehicle"]["cam"]
    grid = cfg["grid_conf"]
    layout = SlotLayout((3, 0, 0))
    b = add_camera_inputs({}, layout, np.random.default_rng(0), img_hw=(256, 352),
                          ncam={"vehicle": 6}, with_depth=False)["cam_vehicle"]
    frustum = create_frustum((256, 352), 8, grid["ddiscr"], grid["mode"])
    geom = get_geometry(torch.from_numpy(frustum).to(cuda), *(
        torch.from_numpy(b[k]).to(cuda)
        for k in ("rots", "trans", "intrinsics", "post_rots", "post_trans")))
    geom = geom.permute(0, 1, 3, 4, 2, 5)  # the lifted order (B, N, fH, fW, D)
    gen = torch.Generator(device=cuda).manual_seed(0)
    depth = torch.softmax(torch.randn(geom.shape[:-1], device=cuda, generator=gen), -1)
    ctx = torch.randn(geom.shape[:-2] + (64,), device=cuda, generator=gen)
    feats = (depth[..., None] * ctx[..., None, :]).to(torch.bfloat16)
    dx, bx, nx = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
    dx_t, lo = torch.from_numpy(dx).to(cuda), torch.from_numpy(bx - dx / 2.0).to(cuda)
    got = voxel_pooling(geom, feats, dx_t, lo, nx)
    exact = voxel_pooling(geom, feats.double(), dx_t, lo, nx)
    abs_sum = voxel_pooling(geom, feats.double().abs(), dx_t, lo, nx)
    count = voxel_pooling(geom, torch.ones_like(feats[..., :1], dtype=torch.double),
                          dx_t, lo, nx)
    assert got.shape == (3, 200, 704, 64) and got.dtype == torch.bfloat16
    u = 2.0 ** -8
    bound = (count - 1).clamp_min(0) * u * abs_sum + u * exact.abs()
    err = (got.double() - exact).abs()
    assert float(count.max()) > 100  # cells near the cameras gather many points
    assert bool((err <= bound * 1.0001 + 1e-30).all()), float((err - bound).max())


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("task", ["det", "seg"])
def test_tiny_v2xvit_model_on_card_matches_cpu(cuda, task, mode, monkeypatch):
    """The tiny V2X-ViT model with seeded random weights on a scene with
    perturbed poses and delays, f32, TF32 off, deterministic cuDNN: the
    card's outputs within 1e-4 x (1 + scale) of the CPU's; K1 three times,
    K2 never (no decode here), K4a once per stride-1 conv in ``pallas``."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import (
        batch_to_torch, make_scene, perturb_poses)
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.ops.warp import rotated_roi_weights
    from airv2x_tpu_torch.utils.weights import init_random_

    hypes = load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml"))
    hypes["model"]["core_method"] = "airv2x_v2xvit"
    hypes["model"]["args"]["transformer"] = {
        "encoder": _chip_smoke().TINY_V2XVIT_ENCODER}
    hypes["task"] = hypes["model"]["args"]["task"] = task
    models = {d: init_random_(build_model(hypes, device=d), seed=3)
              for d in ("cpu", "cuda")}
    b, _ = make_scene(np.random.default_rng(2), models["cpu"].layout,
                      num_objects=6, points_per_agent=2048, pts_per_box=60,
                      lidar_range=hypes["preprocess"]["cav_lidar_range"])
    batch = perturb_poses({k: v[None] for k, v in b.items()},
                          np.random.default_rng(1))
    roi = rotated_roi_weights((48, 48), torch.from_numpy(batch["pairwise_t"]),
                              0.4, 2)
    assert float((roi - 0.5).abs().min()) > 1e-4
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    torch.backends.cudnn.deterministic = True
    try:
        outs = {}
        for d, model in models.items():
            kernels.reset_launch_counts()
            with torch.inference_mode():
                outs[d] = model(batch_to_torch(batch, d))
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert kernels.LAUNCHES["pillar_encode"] == 3
    assert kernels.LAUNCHES["conv3x3"] == (3 if mode == "pallas" else 0)
    keys = ("psm", "rm", "obj") if task == "det" else ("dynamic_seg",
                                                       "static_seg")
    for k in keys:
        want, got = outs["cpu"][k].double(), outs["cuda"][k].cpu().double()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert scale > 0 and err <= 1e-4 * (1 + scale), (k, err, scale)


def test_sttf_warp_full_width_on_card_matches_cpu(cuda):
    """``warp_bev_features`` and ``rotated_roi_mask`` at the full-width
    transformer input (6 agents x 100 x 352 x 256, f32 and bf16) under
    perturbed poses: the card's sample coordinates are the CPU's bit for
    bit (f32 products and sums, no division by a host scalar), so the
    warped maps agree to rounding and the ROI masks exactly."""
    from airv2x_tpu_torch.data.synthetic import perturb_poses
    from airv2x_tpu_torch.ops.warp import (
        rotated_roi_mask, rotated_roi_weights, warp_bev_features)

    rng = np.random.default_rng(0)
    batch = {"pairwise_t": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (1, 6, 4, 4)).copy(),
             "prior_encoding": np.zeros((1, 6, 3), np.float32)}
    perturb_poses(batch, rng)
    pt = torch.from_numpy(batch["pairwise_t"])
    weights = rotated_roi_weights((100, 352), pt, 0.4, 2)
    margin = float((weights - 0.5).abs().min())
    assert margin > 1e-6, margin
    masks = [rotated_roi_mask((100, 352), p, 0.4, 2).cpu() for p in (pt, pt.to(cuda))]
    assert torch.equal(masks[0], masks[1])
    assert not bool(masks[0][:, 1:].all())
    feats = torch.from_numpy(rng.normal(0, 1, (1, 6, 100, 352, 256)).astype(
        np.float32))
    for dt in (torch.float32, torch.bfloat16):
        x = feats.to(dt)
        want = warp_bev_features(x, pt, 0.4, 2)
        got = warp_bev_features(x.to(cuda), pt.to(cuda), 0.4, 2).cpu()
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got[:, 0], x[:, 0].float())
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("resnet", [True, False], ids=["resnet", "plain"])
def test_tiny_scope_model_on_card_matches_cpu(cuda, resnet):
    """The tiny SCOPE model (``chip_smoke.TINY_SCOPE_ARGS``) with seeded
    random weights on two distinct frames with perturbed history and
    ego-row poses, f32, TF32 off, deterministic cuDNN: the card's outputs
    within 1e-4 x (1 + scale) of the CPU's, its comm masks and query cells
    equal; K1 once per frame, no K4."""
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    smoke = _chip_smoke()
    hypes = smoke.tiny_scope_hypes(resnet)
    scene = smoke.tiny_scope_batch(hypes)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for d in ("cpu", "cuda"):
            model = init_random_(build_model(hypes, device=d),
                                 seed=smoke.TINY_SCOPE_SEED)
            kernels.reset_launch_counts()
            runs[d] = smoke.scope_margins(model, batch_to_torch(scene, d))
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert kernels.LAUNCHES["pillar_encode"] == 2
    assert kernels.LAUNCHES["conv3x3"] == 0
    margins, caught, want = runs["cpu"]
    assert min(margins.values()) > smoke.SCOPE_MARGIN, margins
    _, got_caught, got = runs["cuda"]
    same = smoke.scope_same_decisions({"caught": got_caught}, {"caught": caught})
    assert same == {"comm masks equal": True, "query cells differing": 0}
    for k in ("psm", "rm", "psm_single_v", "rm_single_i"):
        w, g = want[k].double(), got[k].cpu().double()
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert scale > 0 and err <= 1e-4 * (1 + scale), (k, err, scale)


@pytest.mark.parametrize("task", ["det", "seg"])
@pytest.mark.parametrize("name", ["airv2x_heal", "airv2x_stamp", "airv2x_sicp"])
def test_tiny_hetero_model_on_card_matches_cpu(cuda, name, task, monkeypatch):
    """The tiny HEAL / STAMP / SiCP models (``chip_smoke.TINY_HETERO``)
    with seeded random weights on phase 4f's scene (perturbed poses, an
    absent drone), f32, TF32 off, deterministic cuDNN, SiCP in ``pallas``:
    the card's outputs within 1e-4 x (1 + scale) of the CPU's; K1 three
    times, K4a once per SiCP backbone conv (none for HEAL / STAMP)."""
    from airv2x_tpu_torch.config import load_yaml
    from airv2x_tpu_torch.data.synthetic import batch_to_torch
    from airv2x_tpu_torch.models import build_model
    from airv2x_tpu_torch.utils.weights import init_random_

    cs = _chip_smoke()
    hypes = cs.tiny_hetero_hypes(
        load_yaml(os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")),
        name, task)
    models = {d: init_random_(build_model(hypes, device=d),
                              seed=cs.TINY_HETERO_SEED) for d in ("cpu", "cuda")}
    scene = cs.tiny_family_scene(hypes)
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", "pallas")
    torch.backends.cudnn.deterministic = True
    try:
        outs = {}
        for d, model in models.items():
            kernels.reset_launch_counts()
            with torch.inference_mode():
                outs[d] = model(batch_to_torch(scene, d))
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    assert kernels.LAUNCHES["pillar_encode"] == 3
    assert kernels.LAUNCHES["conv3x3"] == (3 if name == "airv2x_sicp" else 0)
    keys = ("psm", "rm", "obj") if task == "det" else ("dynamic_seg",
                                                       "static_seg")
    for k in keys:
        want, got = outs["cpu"][k].double(), outs["cuda"][k].cpu().double()
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        assert scale > 0 and err <= 1e-4 * (1 + scale), (k, err, scale)


@pytest.mark.parametrize("align_corners", [False, True])
def test_normalized_warp_on_card_matches_cpu(cuda, align_corners):
    """The normalized warp (HEAL's pyramid levels, SiCP's sender maps) at
    the full-width level 0 map (100 x 352, 64 channels, 6 agents) under
    perturbed poses: the card computes the CPU's sample coordinates, so the
    warped ones canvas (the footprint HEAL and SiCP threshold) is bit-equal
    and the features agree to f32 rounding."""
    from airv2x_tpu_torch.data.synthetic import perturb_poses
    from airv2x_tpu_torch.ops.warp import (
        normalized_pairwise_affine, warp_affine_normalized)

    batch = {"pairwise_t": np.broadcast_to(np.eye(4, dtype=np.float32),
                                           (1, 6, 4, 4)).copy(),
             "prior_encoding": np.zeros((1, 6, 3), np.float32)}
    perturb_poses(batch, np.random.default_rng(5))
    feats = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 6, 100, 352, 64)).astype(np.float32))
    outs = {}
    for d in ("cpu", "cuda"):
        aff = normalized_pairwise_affine(
            torch.from_numpy(batch["pairwise_t"]).to(d), 100, 352, 0.4, 2)
        ones = torch.ones((1, 6, 100, 352, 1), device=d)
        outs[d] = [warp_affine_normalized(t, aff, align_corners=align_corners)
                   for t in (ones, feats.to(d))]
    torch.cuda.synchronize()
    assert torch.equal(outs["cuda"][0].cpu(), outs["cpu"][0])
    err = float((outs["cuda"][1].cpu() - outs["cpu"][1]).abs().max())
    assert err <= 1e-5, err


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pillar_encode_kernel_on_a_merged_early_cloud(cuda, out_dtype):
    """Early fusion's K1 input: six agents' clouds of 20,000 points each
    merged into one cloud of 120,000 on the 704 x 200 grid (one map), the
    agents overlapping so that hot cells gather points of several agents
    (a cell of 600), against the plain version."""
    from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV

    rng = np.random.default_rng(20)
    lr = [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0]
    vfe = FastPillarBEV(num_filters=[64], voxel_size=[0.4, 0.4, 4],
                        lidar_range=lr).to(cuda)
    with torch.no_grad():
        for p in vfe.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
        vfe.bn.running_var.uniform_(0.5, 2.0)
    vfe = vfe.to(out_dtype).eval()
    vfe.bn.float()
    pts = np.zeros((6, 20000, 4), np.float32)
    for a in range(6):  # each agent's cloud around its own position
        centre = rng.uniform([-60, -20], [60, 20])
        pts[a, :, :2] = centre + rng.normal(0, 15, (20000, 2))
        pts[a, :, 2] = rng.uniform(-2.5, 0.5, 20000)
        pts[a, :, 3] = rng.uniform(0, 1, 20000)
        pts[a, :100, :2] = [10.1, 5.1]  # the hot cell every agent hits
    mask = rng.uniform(size=(6, 20000)) > 0.05
    merged = torch.from_numpy(pts.reshape(1, 120000, 4)).to(cuda)
    mmask = torch.from_numpy(mask.reshape(1, 120000)).to(cuda)
    with torch.no_grad():
        ids, feat, aux, params, kw = vfe.kernel_inputs(merged, mmask)
        got = pillar_encode(ids, feat, aux, params, **kw)
        ref = pillar_encode_plain(ids, feat, aux, params, **kw)
    torch.cuda.synchronize()
    cells = kw["cells"]
    occ = _occupied(ids.cpu().numpy(), cells)
    counts = np.bincount(ids.cpu().numpy().ravel(), minlength=cells + 1)[:cells]
    assert counts.max() >= 500 and occ.sum() > 10000
    _check_k1(got, ref, occ, out_dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_pillar_encode_kernel_on_radar_clouds(cuda, out_dtype):
    """The ``_lrf`` twins' second K1 launch: five agents' radar buffers of
    ``max_points // 4`` = 15,000 rows each on the 704 x 200 grid, of which
    2,000-4,000 are valid (the V2X-R dataset's radar clouds: a few thousand
    points in range, noisier than the LiDAR), against the plain version."""
    from airv2x_tpu_torch.ops.fast_pillars import FastPillarBEV

    rng = np.random.default_rng(22)
    lr = [-140.8, -40.0, -3.0, 140.8, 40.0, 1.0]
    vfe = FastPillarBEV(num_filters=[64], voxel_size=[0.4, 0.4, 4],
                        lidar_range=lr).to(cuda)
    with torch.no_grad():
        for p in vfe.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.5, p.shape).astype(np.float32)))
        vfe.bn.running_var.uniform_(0.5, 2.0)
    vfe = vfe.to(out_dtype).eval()
    vfe.bn.float()
    pts = np.zeros((1, 5, 15000, 4), np.float32)
    mask = np.zeros((1, 5, 15000), bool)
    for a in range(5):
        n = int(rng.integers(2000, 4001))
        pts[0, a, :n, :2] = rng.uniform([-70, -40], [70, 40], (n, 2))
        pts[0, a, :n, :2] += rng.normal(0, 0.15, (n, 2))
        pts[0, a, :n, 2] = rng.uniform(-2.5, 0.5, n)
        pts[0, a, :n, 3] = rng.uniform(0, 1, n)
        mask[0, a, :n] = True
    with torch.no_grad():
        ids, feat, aux, params, kw = vfe.kernel_inputs(
            torch.from_numpy(pts).to(cuda), torch.from_numpy(mask).to(cuda))
        before = kernels.LAUNCHES["pillar_encode"]
        got = pillar_encode(ids, feat, aux, params, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["pillar_encode"] == before + 1
        ref = pillar_encode_plain(ids, feat, aux, params, **kw)
    assert got.shape[0] == 5 and ids.shape[-1] == 15000
    occ = _occupied(ids.cpu().numpy(), kw["cells"])
    assert 1500 < occ.sum(1).min() and occ.sum(1).max() < 4001
    _check_k1(got, ref, occ, out_dtype)


def test_bm2cp_voxel_pooling_bf16_within_bound_of_f32(cuda):
    """BM2CP's voxel pooling on the card: the scatter-add of bf16 lifted
    features (a camera of 45 x 80 x 48 frustum points, 64 channels, over
    the 704 x 200 grid) against the f32 sums of the same bf16 values. The
    atomic adds sum in bf16 in no fixed order, each add rounding to bf16
    (unit roundoff 2^-8) a partial sum no larger than the sum of the
    cell's magnitudes: a cell of n points lies within 2^-8 x n x (the sum
    of its points' magnitudes) of the exact sum, the bound asserted."""
    from airv2x_tpu_torch.models.point_pillar_bm2cp_model import (
        bm2cp_voxel_pooling)

    rng = np.random.default_rng(21)
    geom = np.zeros((1, 1, 48, 45, 80, 3), np.float32)
    geom[..., 0] = rng.uniform(-2, 60, geom.shape[:-1])
    geom[..., 1] = rng.uniform(-30, 30, geom.shape[:-1])
    geom[..., 2] = rng.uniform(-3, 3, geom.shape[:-1])
    g = torch.from_numpy(geom).to(cuda)
    feats = torch.from_numpy(rng.normal(0, 1, (1, 1, 48, 45, 80, 64)).astype(
        np.float32)).to(cuda).bfloat16()
    dx = torch.tensor([0.4, 0.4, 20.0], device=cuda)
    lo = torch.tensor([-140.8, -40.0, -10.0], device=cuda)
    nx = (704, 200, 1)
    got = bm2cp_voxel_pooling(g, feats, dx, lo, nx).float()
    exact = bm2cp_voxel_pooling(g, feats.float(), dx, lo, nx)
    mag = bm2cp_voxel_pooling(g, feats.float().abs(), dx, lo, nx)
    count = bm2cp_voxel_pooling(g, torch.ones_like(feats[..., :1]).float(), dx,
                                lo, nx)
    bound = 2.0 ** -8 * mag * count + 1e-6
    assert float(count.max()) > 10  # cells gather many frustum points
    assert bool(((got - exact).abs() <= bound).all()), float(
        ((got - exact).abs() / bound).max())
