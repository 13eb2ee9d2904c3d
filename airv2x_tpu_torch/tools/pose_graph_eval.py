"""Pose-graph refinement evaluation (counterpart of
airv2x_tpu/tools/pose_graph_eval.py), on the host.

    python -m airv2x_tpu_torch.tools.pose_graph_eval [--num_scenes 20]
        [--num_agents 4] [--num_objects 10] [--noise 0.4] [--seed 0]

Scenes of random world boxes seen by agents at random true poses: each
agent's boxes in its own frame, the non-ego poses perturbed by gaussian
noise (``noise`` in x / y, a quarter of it in yaw), refined by
``utils/pose_graph.refine_agent_poses``; prints the mean pose error before
and after, as the JAX tool does from the same draws.
"""

from __future__ import annotations

import argparse

import numpy as np

from airv2x_tpu_torch.utils.pose_graph import refine_agent_poses


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num_scenes", type=int, default=20)
    p.add_argument("--num_agents", type=int, default=4)
    p.add_argument("--num_objects", type=int, default=10)
    p.add_argument("--noise", type=float, default=0.4, help="xyz/yaw std")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the mean pose errors before and after the refinement."""
    opt = parse_args(argv)
    rng = np.random.default_rng(opt.seed)
    errs_before, errs_after = [], []
    for _ in range(opt.num_scenes):
        world = np.stack([rng.uniform(-40, 40, opt.num_objects),
                          rng.uniform(-20, 20, opt.num_objects),
                          rng.uniform(-np.pi, np.pi, opt.num_objects)], axis=-1)
        true_poses = np.zeros((opt.num_agents, 3))
        true_poses[1:, 0] = rng.uniform(-20, 20, opt.num_agents - 1)
        true_poses[1:, 1] = rng.uniform(-10, 10, opt.num_agents - 1)
        true_poses[1:, 2] = rng.uniform(-0.5, 0.5, opt.num_agents - 1)

        def to_frame(pose):
            tx, ty, yaw = pose
            c, s = np.cos(yaw), np.sin(yaw)
            x, y = world[:, 0] - tx, world[:, 1] - ty
            return np.stack([c * x + s * y, -s * x + c * y, world[:, 2] - yaw],
                            axis=-1)

        agent_boxes = [to_frame(pp) for pp in true_poses]
        noisy = true_poses.copy()
        noisy[1:, :2] += rng.normal(0, opt.noise, (opt.num_agents - 1, 2))
        noisy[1:, 2] += rng.normal(0, opt.noise * 0.25, opt.num_agents - 1)
        refined = refine_agent_poses(agent_boxes, noisy)
        errs_before.append(np.abs(noisy[1:] - true_poses[1:]).mean())
        errs_after.append(np.abs(refined[1:] - true_poses[1:]).mean())
    before, after = float(np.mean(errs_before)), float(np.mean(errs_after))
    print(f"mean pose error before: {before:.4f}  after refinement: {after:.4f}  "
          f"({after / max(before, 1e-9):.1%} residual)")
    return {"before": before, "after": after}


if __name__ == "__main__":
    main()
