"""Pose-graph-corrected agent poses over a split (counterpart of
airv2x_tpu/tools/pose_graph_pre_calc.py), on the host.

    python -m airv2x_tpu_torch.tools.pose_graph_pre_calc --hypes_yaml <cfg>
        [--split_dir <AirV2X split>] --output <dir>
        [--pos_std 0.4 ...] [--rot_std 0.1 ...] [--max_samples N]
        [--num_scenes N] [--seed N]

For every sample (the AirV2X split at ``--split_dir``, else the config's
``root_dir``, else ``--num_scenes`` synthetic ``make_scene`` scenes): the
non-ego live agents' poses perturbed by gaussian noise of each
(``pos_std``, ``rot_std``) pair of the sweep, refined by
``utils/pose_graph.refine_agent_poses`` from every live agent's view of the
ego-frame gt boxes, and written as ``sample_{idx:06d}.npz`` (``pairwise_t``
(L, 4, 4), ``agent_mask``) under ``<output>/pos{p}_rot{r}/``: the files the
JAX tool writes, from the same draws.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.airv2x_dataset import AirV2XDataset
from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.utils.pose_graph import refine_agent_poses


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="pose graph precompute")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--split_dir", default="")
    p.add_argument("--output", required=True)
    p.add_argument("--pos_std", type=float, nargs="*", default=[0.4])
    p.add_argument("--rot_std", type=float, nargs="*", default=[0.1])
    p.add_argument("--max_samples", type=int, default=0)
    p.add_argument("--num_scenes", type=int, default=16, help="synthetic fallback")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _boxes_to_se2(boxes, mask):
    """(G, 7) hwl boxes -> (K, 3) [cx, cy, yaw] observations."""
    b = np.asarray(boxes)[np.asarray(mask, bool)]
    return (np.stack([b[:, 0], b[:, 1], b[:, 6]], axis=-1) if len(b)
            else np.zeros((0, 3)))


def _se2_to_mat(pose):
    tx, ty, yaw = pose
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[0, 3] = c, -s, tx
    m[1, 0], m[1, 1], m[1, 3] = s, c, ty
    return m


def main(argv=None) -> dict:
    """Write the sweep's files; returns {sweep dir: mean residual pose
    error}."""
    opt = parse_args(argv)
    if len(opt.pos_std) != len(opt.rot_std):
        raise SystemExit(
            f"--pos_std and --rot_std sweeps must have equal length "
            f"({len(opt.pos_std)} vs {len(opt.rot_std)})")
    hypes = load_yaml(opt.hypes_yaml)
    layout = SlotLayout.from_args(hypes["model"]["args"])
    lidar_range = hypes["preprocess"]["cav_lidar_range"]
    split = opt.split_dir or hypes.get("root_dir", "")
    use_dataset = split and os.path.isdir(split)

    def sample_iter():
        if use_dataset:
            ds = AirV2XDataset(hypes, split, train=False)
            n = min(len(ds), opt.max_samples) if opt.max_samples else len(ds)
            for i in range(n):
                yield ds[i]
        else:
            rng = np.random.default_rng(opt.seed)
            for _ in range(opt.num_scenes):
                yield make_scene(rng, layout, points_per_agent=1024,
                                 lidar_range=lidar_range)

    rng = np.random.default_rng(opt.seed)
    out = {}
    for pos_std, rot_std in zip(opt.pos_std, opt.rot_std):
        out_dir = os.path.join(opt.output, f"pos{pos_std}_rot{rot_std}")
        os.makedirs(out_dir, exist_ok=True)
        residuals = []
        idx = -1
        for idx, (batch, gt) in enumerate(sample_iter()):
            am = np.asarray(batch["agent_mask"], bool)
            obs = _boxes_to_se2(gt["boxes"], gt["mask"])
            # the dataset projects into the ego frame, so every agent's true
            # pose is the identity: the refinement must pull the noisy
            # initialisation back to it
            live = np.where(am)[0]
            noisy = np.zeros((len(live), 3))
            noisy[1:, :2] += rng.normal(0, pos_std, (len(live) - 1, 2))
            noisy[1:, 2] += rng.normal(0, rot_std, len(live) - 1)
            refined = refine_agent_poses([obs for _ in live], noisy)
            pairwise = np.tile(np.eye(4, dtype=np.float32), (am.shape[0], 1, 1))
            for k, slot in enumerate(live):
                pairwise[slot] = _se2_to_mat(refined[k])
            np.savez(os.path.join(out_dir, f"sample_{idx:06d}.npz"),
                     pairwise_t=pairwise, agent_mask=am)
            residuals.append(np.abs(refined[1:]).mean() if len(live) > 1 else 0.0)
        mean_res = float(np.mean(residuals)) if residuals else float("nan")
        print(f"pos_std={pos_std} rot_std={rot_std}: {idx + 1} samples -> "
              f"{out_dir} (mean residual pose error {mean_res:.4f})")
        out[out_dir] = mean_res
    return out


if __name__ == "__main__":
    main()
