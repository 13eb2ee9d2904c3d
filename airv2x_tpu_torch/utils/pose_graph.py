"""CoAlign's agent-object pose-graph refinement on the host (counterpart of
airv2x_tpu/utils/pose_graph.py, numpy and ``scipy.optimize.least_squares``;
a copy, so the port imports nothing of the JAX package).

Noisy relative agent poses are refined by the consistency of the boxes the
agents detect: each agent i has an SE(2) pose x_i = (tx, ty, yaw) in the ego
frame (the ego fixed at the identity) and observes boxes in its own frame;
boxes of two agents are matched greedily by the distance of their centres
under the current poses, and a Huber least-squares fit moves the poses so
matched centres and headings agree. Two rounds of (match -> fit); a fit is
kept only if it gives more tight (0.5 m) cross-agent matches than the
poses it started from. It runs between forwards, on the host.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import least_squares


def _se2_apply(pose, pts):
    tx, ty, yaw = pose
    c, s = np.cos(yaw), np.sin(yaw)
    x = c * pts[:, 0] - s * pts[:, 1] + tx
    y = s * pts[:, 0] + c * pts[:, 1] + ty
    return np.stack([x, y], axis=-1)


def match_boxes(centers_a: np.ndarray, centers_b: np.ndarray, max_dist: float):
    """Greedy nearest-center matching -> list of (ia, ib) pairs."""
    if len(centers_a) == 0 or len(centers_b) == 0:
        return []
    d = np.linalg.norm(centers_a[:, None] - centers_b[None, :], axis=-1)
    pairs = []
    used_b = set()
    for ia in np.argsort(d.min(axis=1)):
        ib = int(np.argmin(d[ia]))
        if ib in used_b or d[ia, ib] > max_dist:
            continue
        pairs.append((int(ia), ib))
        used_b.add(ib)
    return pairs


def refine_agent_poses(
    agent_boxes: list,
    init_poses: np.ndarray,
    *,
    max_match_dist: float = 3.0,
    max_yaw_diff: float = 0.5,
    yaw_weight: float = 2.0,
    huber_delta: float = 1.0,
    rounds: int = 2,
):
    """Refine SE(2) agent poses from per-agent box observations.

    agent_boxes: list over N agents of (K_i, 3) arrays [cx, cy, yaw] in the
    agent's OWN frame. init_poses: (N, 3) initial ego-frame poses (agent 0
    is the ego and stays fixed). Runs ``rounds`` of (match -> optimize) so
    matches improve as poses do; candidate pairs must also agree in heading
    (mod pi, within ``max_yaw_diff``) to reject sparse-scene mispairings.
    """
    n = len(agent_boxes)
    if n <= 1:
        return init_poses.copy()
    poses = init_poses.copy()
    for _ in range(max(rounds, 1)):
        poses = _refine_once(
            agent_boxes, poses, max_match_dist, max_yaw_diff, yaw_weight,
            huber_delta,
        )
    return poses


def _refine_once(
    agent_boxes, init_poses, max_match_dist, max_yaw_diff, yaw_weight,
    huber_delta,
):
    n = len(agent_boxes)
    matches = []  # (i, j, ki, kj)
    for i in range(n):
        for j in range(i + 1, n):
            bi = np.asarray(agent_boxes[i])
            bj = np.asarray(agent_boxes[j])
            ci = _se2_apply(init_poses[i], bi[:, :2]) if len(bi) else np.zeros((0, 2))
            cj = _se2_apply(init_poses[j], bj[:, :2]) if len(bj) else np.zeros((0, 2))
            for ki, kj in match_boxes(ci, cj, max_match_dist):
                dyaw = (bi[ki, 2] + init_poses[i][2]) - (
                    bj[kj, 2] + init_poses[j][2]
                )
                dyaw = abs((dyaw + np.pi / 2) % np.pi - np.pi / 2)  # mod pi
                if dyaw <= max_yaw_diff:
                    matches.append((i, j, ki, kj))
    if not matches:
        return init_poses.copy()

    def unpack(theta):
        poses = init_poses.copy()
        poses[1:] = theta.reshape(n - 1, 3)
        return poses

    def residuals(theta):
        poses = unpack(theta)
        res = []
        for i, j, ki, kj in matches:
            bi = np.asarray(agent_boxes[i])[ki]
            bj = np.asarray(agent_boxes[j])[kj]
            pi = _se2_apply(poses[i], bi[None, :2])[0]
            pj = _se2_apply(poses[j], bj[None, :2])[0]
            res.extend(pi - pj)
            dyaw = (bi[2] + poses[i][2]) - (bj[2] + poses[j][2])
            dyaw = (dyaw + np.pi) % (2 * np.pi) - np.pi
            res.append(yaw_weight * dyaw)
        return np.asarray(res)

    sol = least_squares(
        residuals,
        init_poses[1:].reshape(-1),
        loss="huber",
        f_scale=huber_delta,
        max_nfev=200,
    )
    # consensus acceptance: the refined poses must produce at least as many
    # TIGHT cross-agent agreements (re-matched from scratch at 0.5 m) as the
    # initial ones — guards against mispaired matches dragging poses away
    # under heavy noise, where the optimizer happily satisfies wrong pairs.
    def tight_inliers(poses):
        cnt = 0
        for i in range(n):
            for j in range(i + 1, n):
                bi = np.asarray(agent_boxes[i])
                bj = np.asarray(agent_boxes[j])
                if not len(bi) or not len(bj):
                    continue
                ci = _se2_apply(poses[i], bi[:, :2])
                cj = _se2_apply(poses[j], bj[:, :2])
                cnt += len(match_boxes(ci, cj, 0.5))
        return cnt

    refined = unpack(sol.x)
    if tight_inliers(refined) <= tight_inliers(init_poses):
        return init_poses.copy()
    return refined
