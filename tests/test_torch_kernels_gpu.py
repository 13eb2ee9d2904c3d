"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``gpu`` marker and skips, from inside the
``cuda`` fixture, when no card is present. This file imports neither JAX
nor ``airv2x_tpu``, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import os

import numpy as np
import pytest
import torch

from airv2x_tpu_torch import kernels
from airv2x_tpu_torch.ops.pillar_encode import pillar_encode, pillar_encode_plain
from airv2x_tpu_torch.ops.quad_iou import quad_iou, quad_iou_plain

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    args = [torch.from_numpy(a).to(cuda)
            for a in _encode_inputs(rng, m, n, c, cells)]
    kw = dict(cells=cells, nx=nx, out_dtype=out_dtype,
              grid_consts=(0.4, 0.4, -140.6, -7.2, -1.0))
    before = kernels.LAUNCHES["pillar_encode"]
    got = pillar_encode(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pillar_encode"] == before + 1
    ref = pillar_encode_plain(*args, **kw)
    assert got.shape == (m, cells, c) and got.dtype == out_dtype
    # residual sums are atomic adds in run-dependent order: a few f32 ulps
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), atol=tol, rtol=tol)


def test_pillar_encode_kernel_empty_cloud(cuda):
    ids = torch.full((2, 64), 10, dtype=torch.int32, device=cuda)
    feat = torch.zeros((2, 64, 8), device=cuda)
    aux = torch.zeros((2, 64, 4), device=cuda)
    params = torch.ones((7, 8), device=cuda)
    out = pillar_encode(ids, feat, aux, params, cells=10, nx=5,
                        grid_consts=(1.0, 1.0, 0.5, 0.5, 0.0))
    assert out.shape == (2, 10, 8)
    assert float(out.abs().max()) == 0.0


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
    assert kernels.LAUNCHES == {"pillar_encode": 3, "quad_iou": 1}
    for k in ("psm", "rm", "obj", "comm_rate"):
        torch.testing.assert_close(outs["cuda"][k].cpu(), outs["cpu"][k],
                                   atol=1e-4, rtol=1e-4)
    assert int(dets["cuda"].mask.sum()) > 0
