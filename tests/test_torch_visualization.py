"""The port's renders (``airv2x_tpu_torch/visualization/``) against the JAX
package's on the CPU, pixel for pixel: ``CanvasBEV`` / ``visualize``, and
``Canvas3D``'s projection and its numpy drawing. The JAX 3-D canvas draws
its circles, lines and text with OpenCV where OpenCV is installed and with
numpy where it is not; the port always draws with numpy, so the test sets
the JAX module's ``cv2`` to None (inside the test only) to reach that path.
"""

import numpy as np
import pytest

from airv2x_tpu.visualization import bev_canvas as jax_bev
from airv2x_tpu.visualization import canvas_3d as jax_c3d
from airv2x_tpu_torch.visualization import bev_canvas, canvas_3d

RANGE = [-19.2, -19.2, -3, 19.2, 19.2, 1]


def _scene(rng, n_boxes=6):
    pts = np.concatenate([rng.uniform(-22, 22, (3000, 2)),
                          rng.uniform(-3, 1, (3000, 1)),
                          rng.uniform(0, 1, (3000, 1))], axis=1).astype(np.float32)
    ctr = rng.uniform(-18, 18, (n_boxes, 1, 2))
    yaw = rng.uniform(-np.pi, np.pi, n_boxes)
    quad = np.array([[2, 1], [2, -1], [-2, -1], [-2, 1]], np.float64)
    rot = np.stack([np.stack([np.cos(yaw), -np.sin(yaw)], -1),
                    np.stack([np.sin(yaw), np.cos(yaw)], -1)], 1)
    bev = (np.einsum("nij,kj->nki", rot, quad) + ctr).astype(np.float32)
    z = rng.uniform(-2, 0, (n_boxes, 1, 1))
    c3 = np.concatenate([np.concatenate([bev, np.broadcast_to(z, (n_boxes, 4, 1))], -1),
                         np.concatenate([bev, np.broadcast_to(z + 1.5, (n_boxes, 4, 1))], -1)],
                        axis=1).astype(np.float32)
    return pts, bev, c3


@pytest.mark.parametrize("agents", [False, True])
def test_bev_visualize_is_pixel_identical(agents, tmp_path):
    rng = np.random.default_rng(1)
    pts, bev, c3 = _scene(rng)
    kw = {}
    if agents:
        kw["agent_points"] = {"vehicle": pts[:1000], "rsu": pts[1000:2000],
                              "drone": pts[2000:]}
    want = jax_bev.visualize(c3[:3], bev[3:], pts, RANGE, canvas_shape=(200, 300), **kw)
    got = bev_canvas.visualize(c3[:3], bev[3:], pts, RANGE,
                               save_path=str(tmp_path / "bev.png"),
                               canvas_shape=(200, 300), **kw)
    assert got.dtype == np.uint8 and got.shape == (200, 300, 3)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any() and (tmp_path / "bev.png").stat().st_size > 0
    canvas = bev_canvas.CanvasBEV((120, 90), RANGE)
    ref = jax_bev.CanvasBEV((120, 90), RANGE)
    for c in (canvas, ref):
        c.draw_boxes(bev, (1, 2, 3), thickness=3)
        c.draw_points(np.zeros((0, 3)))
    np.testing.assert_array_equal(canvas.canvas, ref.canvas)


CAMERAS = [dict(), dict(left_hand=True),
           dict(camera_pose=[-25.0, 3.0, 12.0, 0.0, 10.0, -20.0]),
           dict(camera_center_coords=(0.0, 0.0, 60.0),
                camera_focus_coords=(0.0, 0.0, 0.0), focal_length=300)]


@pytest.mark.parametrize("cam", range(len(CAMERAS)))
def test_canvas_3d_matches_jax_numpy_path(cam, monkeypatch, tmp_path):
    monkeypatch.setattr(jax_c3d, "cv2", None)
    rng = np.random.default_rng(2 + cam)
    pts, _, c3 = _scene(rng)
    ours = canvas_3d.Canvas3D(canvas_shape=(240, 400), **CAMERAS[cam])
    ref = jax_c3d.Canvas3D(canvas_shape=(240, 400), **CAMERAS[cam])

    for depth in (False, True):
        got = ours.get_canvas_coords(pts, return_depth=depth)
        want = ref.get_canvas_coords(pts, return_depth=depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert ours.get_canvas_coords(pts)[1].any()

    for c in (ours, ref):
        c.draw_points(pts[:, :3], (160, 160, 160))
        c.draw_points(pts[:200, :3], "viridis", radius=2, colors_operand=pts[:200, 2])
        c.draw_lines(pts[:20, :3], pts[20:40, :3], colors=(9, 200, 30))
        c.draw_boxes(c3, (255, 60, 60), texts=[f"#{i}" for i in range(len(c3))])
        c.draw_boxes(c3[:2] + 1.0, (60, 255, 60), draw_incomplete_boxes=False)
    np.testing.assert_array_equal(ours.get_canvas(), ref.get_canvas())
    np.testing.assert_array_equal(ours.depth, ref.depth)
    assert (ours.get_canvas() == [255, 60, 60]).all(-1).any()
    ours.save(str(tmp_path / "c3d.png"))
    assert (tmp_path / "c3d.png").stat().st_size > 0
