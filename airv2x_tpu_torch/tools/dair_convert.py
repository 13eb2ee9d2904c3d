"""Convert a raw DAIR-V2X-C tree into the normalized schema that
``airv2x_tpu_torch.data.dair_dataset.DAIRDataset`` reads (counterpart of
airv2x_tpu/tools/dair_convert.py).

  * vehicle lidar pose = the pose of novatel_to_world after lidar_to_novatel;
  * infrastructure lidar pose = the pose of virtuallidar_to_world plus the
    frame's system error offset (the dataset's calib chain);
  * cooperative labels: each ``world_8_points`` corner set -> a world-frame
    {location, rotation, extent} entry (the dataset projects it into the
    ego frame).

Usage:
  python -m airv2x_tpu_torch.tools.dair_convert --raw_dir <DAIR-V2X-C root> \\
      --out_dir <normalized root> [--split_json co_split.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from airv2x_tpu_torch.data.dair_dataset import (
    inf_lidar_to_world, veh_lidar_to_world)
from airv2x_tpu_torch.utils import transforms as tf


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def corners_to_label(corners_world) -> dict:
    """(8, 3) world corners -> {location, rotation, extent} (world frame):
    bottom face 0-3, top face 4-7, edge 0-1 along the box length."""
    c = np.asarray(corners_world, np.float64)
    center = c.mean(axis=0)
    length = float(np.linalg.norm(c[1, :2] - c[0, :2]))
    width = float(np.linalg.norm(c[3, :2] - c[0, :2]))
    height = float(c[:, 2].max() - c[:, 2].min())
    d = c[1, :2] - c[0, :2]
    return {"location": [float(center[0]), float(center[1]), float(center[2])],
            "rotation": float(np.arctan2(d[1], d[0])),
            "extent": [length / 2, width / 2, height / 2]}


def convert_frame(raw_dir: str, info: dict, out_label_dir: str) -> dict:
    """One raw ``data_info`` entry -> its normalized entry; writes the
    frame's label file under ``out_label_dir``."""
    veh_id = os.path.basename(info["vehicle_pointcloud_path"]).split(".")[0]
    inf_id = os.path.basename(info["infrastructure_pointcloud_path"]).split(".")[0]
    l2n = _load_json(os.path.join(
        raw_dir, "vehicle-side/calib/lidar_to_novatel", f"{veh_id}.json"))
    n2w = _load_json(os.path.join(
        raw_dir, "vehicle-side/calib/novatel_to_world", f"{veh_id}.json"))
    v2w = _load_json(os.path.join(
        raw_dir, "infrastructure-side/calib/virtuallidar_to_world",
        f"{inf_id}.json"))
    veh_pose = tf.world_to_pose(veh_lidar_to_world(l2n, n2w))
    inf_pose = tf.world_to_pose(
        inf_lidar_to_world(v2w, info.get("system_error_offset")))
    labels_raw = _load_json(os.path.join(raw_dir, info["cooperative_label_path"]))
    labels = [corners_to_label(obj["world_8_points"]) for obj in labels_raw
              if "world_8_points" in obj]
    with open(os.path.join(out_label_dir, f"label_{veh_id}.json"), "w") as f:
        json.dump(labels, f)
    return {
        "vehicle_pointcloud_path": info["vehicle_pointcloud_path"],
        "infrastructure_pointcloud_path": info["infrastructure_pointcloud_path"],
        "vehicle_lidar_pose": veh_pose,
        "infrastructure_lidar_pose": inf_pose,
        "cooperative_label_path": os.path.join("cooperative",
                                               f"label_{veh_id}.json"),
    }


def convert(raw_dir: str, out_dir: str, split: list | None = None) -> int:
    """Convert every frame of ``raw_dir`` (those whose vehicle frame id is in
    ``split``, when given) into ``out_dir``; returns the frame count."""
    frames = _load_json(os.path.join(raw_dir, "cooperative/data_info.json"))
    if split is not None:
        keep = set(split)
        frames = [f for f in frames if os.path.basename(
            f["vehicle_pointcloud_path"]).split(".")[0] in keep]
    out_label_dir = os.path.join(out_dir, "cooperative")
    os.makedirs(out_label_dir, exist_ok=True)
    out_frames = [convert_frame(raw_dir, info, out_label_dir) for info in frames]
    with open(os.path.join(out_dir, "cooperative", "data_info.json"), "w") as f:
        json.dump(out_frames, f, indent=1)
    return len(out_frames)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--raw_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--split_json", default="", help="json list of frame ids")
    opt = p.parse_args(argv)
    split = _load_json(opt.split_json) if opt.split_json else None
    n = convert(opt.raw_dir, opt.out_dir, split)
    print(f"converted {n} frames -> {opt.out_dir}")
    return n


if __name__ == "__main__":
    main()
