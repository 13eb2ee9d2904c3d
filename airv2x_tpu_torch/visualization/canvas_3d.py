"""Perspective 3-D canvas, the counterpart of
airv2x_tpu/visualization/canvas_3d.py.

A virtual pinhole camera, placed either by centre and focus coordinates or
by a 6-DoF pose; left-hand coordinates; ``get_canvas_coords`` projection
with validity masks; points with per-point colours, matplotlib colour maps
over an operand and circle radii; 3-D line segments; 3-D boxes with
optional text labels. Every primitive is drawn in numpy (text through PIL):
this module never uses OpenCV, so its pixels are the same on every machine.
The JAX module draws with OpenCV's antialiased primitives where OpenCV is
installed, and with these numpy ones where it is not.
"""

from __future__ import annotations

import numpy as np

_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def look_at_extrinsic(center, focus):
    """World -> camera 4x4 for a camera at ``center`` looking at ``focus``.

    Camera frame: +z forward (the view direction), +x right, +y down.
    """
    center = np.asarray(center, np.float64)
    fwd = np.asarray(focus, np.float64) - center
    fwd = fwd / (np.linalg.norm(fwd) + 1e-12)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.999:  # looking straight up / down: world +x is up
        up = np.array([1.0, 0.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right) + 1e-12
    down = np.cross(fwd, right)  # completes a right-handed (x, y, z) frame
    rot = np.stack([right, down, fwd])  # rows = camera axes in world coords
    ext = np.eye(4)
    ext[:3, :3] = rot
    ext[:3, 3] = -rot @ center
    return ext


def _per_item_colors(colors, n, colors_operand=None):
    """None -> white, tuple -> broadcast, (N, 3) array -> as it is, str ->
    the matplotlib colour map over ``colors_operand`` scaled to [0, 1]."""
    if colors is None:
        return np.full((n, 3), 255, np.uint8)
    if isinstance(colors, tuple):
        return np.tile(np.asarray(colors, np.uint8), (n, 1))
    if isinstance(colors, str):
        if colors_operand is None:
            raise ValueError("cmap colors need colors_operand")
        import matplotlib

        op = np.asarray(colors_operand, np.float64)
        op = op - op.min()
        op = op / (op.max() + 1e-12)
        cmap = matplotlib.colormaps[colors]
        return (cmap(op)[:, :3] * 255).astype(np.uint8)
    colors = np.asarray(colors)
    if len(colors) != n:
        raise ValueError(f"{len(colors)} colors for {n} items")
    return colors.astype(np.uint8)


class Canvas3D:
    """Virtual-camera renderer for points and 3-D boxes.

    Pass either ``camera_center_coords`` / ``camera_focus_coords`` or a
    6-DoF ``camera_pose`` (x y z roll yaw pitch, degrees).
    """

    def __init__(self, canvas_shape=(600, 1000), camera_pose=None,
                 fov_deg: float = 70.0, camera_center_coords=(-20.0, 0.0, 10.0),
                 camera_focus_coords=(-20.0 + 0.9396926, 0.0, 10.0 - 0.44202014),
                 focal_length=None, canvas_bg_color=(0, 0, 0),
                 left_hand: bool = False):
        self.h, self.w = canvas_shape
        self.H, self.W = canvas_shape  # the reference's attribute names
        self.left_hand = left_hand
        self.canvas_bg_color = tuple(canvas_bg_color)
        if camera_pose is not None:
            from airv2x_tpu_torch.utils import transforms as tf

            self.world_to_cam_repo = np.linalg.inv(tf.pose_to_world(camera_pose))
            self._mode = "pose"
        else:
            if left_hand:  # the camera is mirrored too
                camera_center_coords = (camera_center_coords[0],
                                        -camera_center_coords[1],
                                        camera_center_coords[2])
                camera_focus_coords = (camera_focus_coords[0],
                                       -camera_focus_coords[1],
                                       camera_focus_coords[2])
            self.ext_matrix = look_at_extrinsic(camera_center_coords,
                                                camera_focus_coords)
            self._mode = "lookat"
        if focal_length is None:  # half the larger canvas side, or the fov's
            focal_length = (max(self.h, self.w) // 2 if camera_pose is None
                            else (self.w / 2) / np.tan(np.radians(fov_deg) / 2))
        self.f = float(focal_length)
        self.clear_canvas()

    def clear_canvas(self):
        self.canvas = np.empty((self.h, self.w, 3), np.uint8)
        self.canvas[...] = np.asarray(self.canvas_bg_color, np.uint8)
        self.depth = np.full((self.h, self.w), np.inf, np.float32)

    def get_canvas(self):
        return self.canvas

    def _camera_xyz(self, pts):
        pts = np.asarray(pts, np.float64)[:, :3]
        if self._mode == "pose":
            cam = pts @ self.world_to_cam_repo[:3, :3].T + self.world_to_cam_repo[:3, 3]
            # the pose convention: camera x forward, y left, z up
            return np.stack([-cam[:, 1], -cam[:, 2], cam[:, 0]], axis=-1)
        if self.left_hand:
            pts = pts * np.array([1.0, -1.0, 1.0])
        return pts @ self.ext_matrix[:3, :3].T + self.ext_matrix[:3, 3]

    def get_canvas_coords(self, xyz, depth_min: float = 0.1,
                          return_depth: bool = False):
        """Project (N, 3+) world points: integer (row, col) canvas coords
        and a validity mask (and the depth)."""
        cam = self._camera_xyz(xyz)
        depth = cam[:, 2]
        safe = np.maximum(depth, 1e-6)
        col = np.round(self.w / 2 + self.f * cam[:, 0] / safe).astype(np.int32)
        row = np.round(self.h / 2 + self.f * cam[:, 1] / safe).astype(np.int32)
        xy = np.stack([row, col], axis=-1)
        valid = ((depth > depth_min) & (row >= 0) & (row < self.h)
                 & (col >= 0) & (col < self.w))
        if return_depth:
            return xy, valid, depth
        return xy, valid

    def draw_canvas_points(self, canvas_xy, radius: int = -1,
                           colors=(128, 64, 0), colors_operand=None):
        """Draw projected, valid (row, col) points: radius -1 = single
        pixels, r > 0 = filled discs."""
        canvas_xy = np.asarray(canvas_xy)
        if len(canvas_xy) == 0:
            return
        cols = _per_item_colors(colors, len(canvas_xy), colors_operand)
        if radius == -1:
            self.canvas[canvas_xy[:, 0], canvas_xy[:, 1]] = cols
            return
        dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
        disk = (dy ** 2 + dx ** 2) <= radius ** 2
        for c, (r, cc) in zip(cols, canvas_xy):
            ys = np.clip(r + dy[disk], 0, self.h - 1)
            xs = np.clip(cc + dx[disk], 0, self.w - 1)
            self.canvas[ys, xs] = c

    def draw_points(self, pts, color=(255, 255, 255), radius: int = -1,
                    colors_operand=None):
        """Project and draw world points, z-buffered (single pixels)."""
        pts = np.asarray(pts)
        if len(pts) == 0:
            return
        xy, ok, depth = self.get_canvas_coords(pts, return_depth=True)
        if radius != -1 or isinstance(color, str) or (
                isinstance(color, np.ndarray) and color.ndim == 2):
            cols = _per_item_colors(color, len(pts), colors_operand)
            self.draw_canvas_points(xy[ok], radius=radius, colors=cols[ok])
            return
        xy, depth = xy[ok], depth[ok]
        closer = depth < self.depth[xy[:, 0], xy[:, 1]]
        xy, depth = xy[closer], depth[closer]
        self.canvas[xy[:, 0], xy[:, 1]] = color
        self.depth[xy[:, 0], xy[:, 1]] = depth

    def draw_lines(self, start_xyz, end_xyz, colors=(255, 255, 255),
                   thickness: int = 1):
        """3-D segments; both endpoints must project."""
        start_xyz, end_xyz = np.asarray(start_xyz), np.asarray(end_xyz)
        cols = _per_item_colors(colors, len(start_xyz))
        sxy, sok = self.get_canvas_coords(start_xyz)
        exy, eok = self.get_canvas_coords(end_xyz)
        for c, a, b, ok in zip(cols.tolist(), sxy, exy, sok & eok):
            if ok:
                self._line(a, b, tuple(c), thickness)

    def draw_boxes(self, corners3d, colors=(255, 60, 60), texts=None,
                   depth_min: float = 0.1, draw_incomplete_boxes: bool = True,
                   box_line_thickness: int = 1, box_text_size: float = 0.5,
                   text_corner: int = 1):
        """corners3d (N, 8, 3) world boxes, with optional text at one
        corner. By default the visible edges of a box partly out of view
        are drawn; ``draw_incomplete_boxes=False`` skips such a box."""
        corners3d = np.asarray(corners3d)
        if corners3d.size == 0:
            return
        n = len(corners3d)
        cols = _per_item_colors(colors, n)
        xy, ok = self.get_canvas_coords(corners3d.reshape(-1, 3),
                                        depth_min=depth_min)
        xy, ok = xy.reshape(n, 8, 2), ok.reshape(n, 8)
        for i in range(n):
            if not draw_incomplete_boxes and ok[i].sum() != 8:
                continue
            color = tuple(cols[i].tolist())
            for a, b in _EDGES:
                if ok[i, a] and ok[i, b]:
                    self._line(xy[i, a], xy[i, b], color, box_line_thickness)
            if texts is not None and ok[i].any():
                self._text(str(texts[i]), xy[i, text_corner], color)

    def _line(self, a, b, color, thickness: int = 1):
        n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1]))) + 1
        n = min(n, 4 * max(self.h, self.w))
        ys = np.linspace(a[0], b[0], n)
        xs = np.linspace(a[1], b[1], n)
        keep = (ys >= 0) & (ys < self.h) & (xs >= 0) & (xs < self.w)
        self.canvas[ys[keep].astype(np.int32), xs[keep].astype(np.int32)] = color

    def _text(self, s, xy, color):
        from PIL import Image, ImageDraw

        img = Image.fromarray(self.canvas)
        ImageDraw.Draw(img).text((int(xy[1]), int(xy[0])), s, fill=color)
        self.canvas[...] = np.asarray(img)

    def save(self, path: str):
        from PIL import Image

        Image.fromarray(self.canvas).save(path)
