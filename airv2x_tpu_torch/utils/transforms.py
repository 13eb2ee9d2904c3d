"""Host-side pose / SE(3) math (numpy; copy of airv2x_tpu/utils/transforms.py).

Carla-style 6-DoF poses ``[x, y, z, roll, yaw, pitch]`` in degrees are used by
the AirV2X dataset metadata.  Behavioural parity with the reference
(`opencood/utils/transformation_utils.py:216-285` — ``x_to_world`` /
``x1_to_x2``) is covered by golden unit tests; the implementation here is
written against the underlying math (intrinsic yaw-pitch-roll Euler with
Carla's left-handed convention), not translated.

These run on the host inside the input pipeline — device code receives only
finished 4x4 matrices.
"""

from __future__ import annotations

import numpy as np


def pose_to_world(pose) -> np.ndarray:
    """4x4 transform taking points in the ``pose`` frame into world frame.

    ``pose``: array-like ``[x, y, z, roll, yaw, pitch]`` (degrees).
    Equivalent contract to reference ``x_to_world``
    (transformation_utils.py:216).
    """
    x, y, z, roll, yaw, pitch = np.asarray(pose, dtype=np.float64)[:6]
    cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    cp, sp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
    cr, sr = np.cos(np.radians(roll)), np.sin(np.radians(roll))

    # Carla rotation: R = Rz(yaw) @ Ry(pitch) @ Rx_left(roll); assembled
    # directly to keep the exact same element expressions as the convention.
    T = np.eye(4, dtype=np.float64)
    T[0, 3], T[1, 3], T[2, 3] = x, y, z
    T[0, 0] = cp * cy
    T[0, 1] = cy * sp * sr - sy * cr
    T[0, 2] = -cy * sp * cr - sy * sr
    T[1, 0] = sy * cp
    T[1, 1] = sy * sp * sr + cy * cr
    T[1, 2] = -sy * sp * cr + cy * sr
    T[2, 0] = sp
    T[2, 1] = -cp * sr
    T[2, 2] = cp * cr
    return T


def world_to_pose(T: np.ndarray):
    """Inverse of :func:`pose_to_world`: a 4x4 frame -> world transform back
    to ``[x, y, z, roll, yaw, pitch]`` in degrees (contract of reference
    ``tfm_to_pose``, transformation_utils.py:109)."""
    T = np.asarray(T, dtype=np.float64)
    yaw = np.degrees(np.arctan2(T[1, 0], T[0, 0]))
    roll = np.degrees(np.arctan2(-T[2, 1], T[2, 2]))
    pitch = np.degrees(np.arctan2(T[2, 0], np.sqrt(T[2, 1] ** 2 + T[2, 2] ** 2)))
    x, y, z = T[:3, 3]
    return [float(x), float(y), float(z), float(roll), float(yaw), float(pitch)]


def pose_a_to_b(pose_a, pose_b) -> np.ndarray:
    """4x4 transform taking points in frame ``a`` to frame ``b`` (T_b_a).

    Contract of reference ``x1_to_x2`` (transformation_utils.py:262).
    """
    t_w_a = pose_to_world(pose_a)
    t_w_b = pose_to_world(pose_b)
    return np.linalg.solve(t_w_b, t_w_a)


def transform_points(points: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to (N, 3+) points; extra feature columns pass through."""
    out = points.copy()
    xyz = points[:, :3]
    out[:, :3] = xyz @ T[:3, :3].T + T[:3, 3]
    return out


def add_pose_noise(pose, rng: np.random.Generator, xyz_std: float, ryp_std: float):
    """Lossy-localization simulation: gaussian noise on x/y and yaw.

    Mirrors the reference ``wild_setting`` location-noise model
    (basedataset.py:699-758): noise applied to planar position and heading
    only, leaving z / roll / pitch exact.
    """
    pose = np.asarray(pose, dtype=np.float64).copy()
    pose[0] += rng.normal(0.0, xyz_std)
    pose[1] += rng.normal(0.0, xyz_std)
    pose[4] += rng.normal(0.0, ryp_std)
    return pose
