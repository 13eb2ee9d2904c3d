"""BEV visualisation: a point cloud and boxes rasterised on a bird's-eye
canvas and saved as a PNG, the counterpart of
airv2x_tpu/visualization/bev_canvas.py (numpy and PIL, on the host).
"""

from __future__ import annotations

import numpy as np

AGENT_COLORS = {
    "vehicle": (60, 180, 255),
    "rsu": (255, 200, 60),
    "drone": (180, 120, 255),
}
PRED_COLOR = (255, 60, 60)
GT_COLOR = (60, 255, 120)


class CanvasBEV:
    """A rasterising BEV canvas of ``canvas_shape`` (rows, cols) over the
    x / y extent of ``lidar_range``."""

    def __init__(self, canvas_shape=(800, 2816),
                 lidar_range=(-140.8, -40, -3, 140.8, 40, 1)):
        self.h, self.w = canvas_shape
        self.range = lidar_range
        self.canvas = np.zeros((self.h, self.w, 3), np.uint8)

    def _to_px(self, xy):
        lr = self.range
        px = (xy[:, 0] - lr[0]) / (lr[3] - lr[0]) * (self.w - 1)
        py = (xy[:, 1] - lr[1]) / (lr[4] - lr[1]) * (self.h - 1)
        return np.stack([py, px], axis=-1)

    def draw_points(self, points_xy, color=(255, 255, 255)):
        if len(points_xy) == 0:
            return
        p = self._to_px(np.asarray(points_xy)[:, :2]).astype(np.int32)
        keep = (p[:, 0] >= 0) & (p[:, 0] < self.h) & (p[:, 1] >= 0) & (p[:, 1] < self.w)
        p = p[keep]
        self.canvas[p[:, 0], p[:, 1]] = color

    def draw_boxes(self, corners_bev, color=(255, 60, 60), thickness: int = 1):
        """corners_bev: (N, 4, 2) BEV quads in metres."""
        for quad in np.asarray(corners_bev):
            px = self._to_px(quad)
            for i in range(4):
                self._line(px[i], px[(i + 1) % 4], color, thickness)

    def _line(self, a, b, color, thickness):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        ys = np.linspace(a[0], b[0], n).astype(np.int32)
        xs = np.linspace(a[1], b[1], n).astype(np.int32)
        for dy in range(-(thickness // 2), thickness // 2 + 1):
            yy = np.clip(ys + dy, 0, self.h - 1)
            xx = np.clip(xs, 0, self.w - 1)
            self.canvas[yy, xx] = color

    def save(self, path: str):
        from PIL import Image

        Image.fromarray(self.canvas).save(path)


def visualize(pred_corners, gt_corners, points, lidar_range,
              save_path: str | None = None, *, agent_points: dict | None = None,
              canvas_shape=(800, 2816)):
    """Render one frame; returns the (H, W, 3) uint8 canvas.

    pred_corners / gt_corners: (N, 8, 3) or (N, 4, 2); points: (P, 3+);
    agent_points: optional {'vehicle': pts, 'rsu': pts, 'drone': pts},
    coloured per agent type.
    """
    canvas = CanvasBEV(canvas_shape, lidar_range)
    if agent_points:
        for t, pts in agent_points.items():
            canvas.draw_points(pts, AGENT_COLORS.get(t, (255, 255, 255)))
    elif points is not None and len(points):
        canvas.draw_points(points)

    def bev(c):
        c = np.asarray(c)
        return c[:, :4, :2] if c.ndim == 3 else c

    if gt_corners is not None and len(gt_corners):
        canvas.draw_boxes(bev(gt_corners), GT_COLOR, thickness=2)
    if pred_corners is not None and len(pred_corners):
        canvas.draw_boxes(bev(pred_corners), PRED_COLOR)
    if save_path:
        canvas.save(save_path)
    return canvas.canvas
