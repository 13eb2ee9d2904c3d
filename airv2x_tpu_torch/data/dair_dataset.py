"""The DAIR-V2X vehicle + infrastructure dataset -> fixed-shape samples
(counterpart of airv2x_tpu/data/dair_dataset.py, the LiDAR branch).

A fixed 2-agent setup (slot 0 the ego vehicle, slot 1 the roadside unit),
frames indexed by ``cooperative/data_info.json``. Two on-disk schemas:

  * the raw DAIR-V2X release: entries with point-cloud paths and a
    per-frame ``system_error_offset``; the poses come from the calib chain
    (vehicle lidar_to_novatel then novatel_to_world; infrastructure
    virtuallidar_to_world plus the offset), the labels are cooperative
    ``world_8_points`` corner sets projected into the ego frame and
    converted to hwl boxes in float32 (``corner_to_center_hwl``), with the
    z-expanded range mask;
  * the normalized schema of ``tools/dair_convert.py``: precomputed
    ``vehicle_lidar_pose`` / ``infrastructure_lidar_pose`` and world-frame
    {location, rotation, extent} labels.

Wild settings add gaussian localization noise to the infrastructure pose,
drawn from ``np.random.default_rng((seed, idx))``. ``__getitem__`` takes
the sample index only, as the JAX package's does: ``RealDataLoader`` (which
passes ``epoch``) cannot draw from it, and DAIR batches are collated from a
list of samples (``RealDataLoader._collate``). A config whose vehicle or
rsu args hold a ``cam`` block gets one camera per slot from the raw calib
chain (``cam_vehicle``); as in the JAX package, the ``dair_bm2cp`` YAML
(``img_params`` at the top of the model args) loads none, and no sample
carries ``depth_maps`` (ROADMAP §3).
"""

from __future__ import annotations

import json
import os

import numpy as np

from airv2x_tpu_torch.data.airv2x_dataset import WildSettings, corner_to_center_hwl
from airv2x_tpu_torch.data.pcd import load_pcd_into
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.utils import transforms as tf


def _load_json(path):
    with open(path) as f:
        return json.load(f)


# --- the raw DAIR-V2X calib chain (utils/transformation_utils.py:452-507) ---


def _mult_coord(rot_a2b, trans_a2b, rot_b2c, trans_b2c):
    """Compose a -> b with b -> c: (rotation (3, 3), translation (3, 1))."""
    rot_a2b = np.array(rot_a2b, np.float64).reshape(3, 3)
    rot_b2c = np.array(rot_b2c, np.float64).reshape(3, 3)
    rot = rot_b2c @ rot_a2b
    trans = (rot_b2c @ np.array(trans_a2b, np.float64).reshape(3, 1)
             + np.array(trans_b2c, np.float64).reshape(3, 1))
    return rot, trans


def _rt_matrix(rot, trans):
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = np.array(rot, np.float64).reshape(3, 3)
    m[:3, 3] = np.array(trans, np.float64).reshape(3)
    return m


def veh_lidar_to_world(lidar_to_novatel: dict, novatel_to_world: dict):
    """The vehicle lidar -> world transform (4, 4)."""
    rot, trans = _mult_coord(
        lidar_to_novatel["transform"]["rotation"],
        lidar_to_novatel["transform"]["translation"],
        novatel_to_world["rotation"], novatel_to_world["translation"])
    return _rt_matrix(rot, trans)


def inf_lidar_to_world(virtuallidar_to_world: dict, system_error_offset: dict):
    """The infrastructure lidar -> world transform (4, 4); the frame's
    system error offset shifts its translation in x and y."""
    trans = np.array(virtuallidar_to_world["translation"],
                     np.float64).reshape(3, 1).copy()
    if system_error_offset:
        trans[0, 0] += float(system_error_offset["delta_x"])
        trans[1, 0] += float(system_error_offset["delta_y"])
    return _rt_matrix(virtuallidar_to_world["rotation"], trans)


def camera_to_lidar_matrix(lidar_to_camera: dict):
    """The inverse of a lidar -> camera calib entry (4, 4)."""
    return np.linalg.inv(_rt_matrix(lidar_to_camera["rotation"],
                                    lidar_to_camera["translation"]))


def _world_8_points_to_box(corners_world, world_to_lidar, lidar_range):
    """World-frame corners (8, 3) -> hwl box in the lidar frame (float32),
    or None when its centre lies outside the range (z widened by 1 m)."""
    c = np.pad(np.asarray(corners_world, np.float64), ((0, 0), (0, 1)),
               constant_values=1.0)
    c_lidar = (world_to_lidar @ c.T).T[:, :3]
    box = corner_to_center_hwl(c_lidar.astype(np.float32))
    lr = list(lidar_range)
    if not (lr[0] < box[0] < lr[3] and lr[1] < box[1] < lr[4]
            and (lr[2] - 1) < box[2] < (lr[5] + 1)):
        return None
    return box


def _dair_raw_frame(root: str, info: dict):
    """One raw ``data_info`` entry resolved into the normalized schema
    through the calib chain (with each side's camera calibration where its
    files exist)."""
    veh_frame_id = os.path.splitext(
        os.path.basename(info["vehicle_pointcloud_path"]))[0]
    inf_frame_id = os.path.splitext(
        os.path.basename(info["infrastructure_pointcloud_path"]))[0]

    def calib(rel):
        p = os.path.join(root, rel)
        return _load_json(p) if os.path.isfile(p) else None

    l2n = calib(f"vehicle-side/calib/lidar_to_novatel/{veh_frame_id}.json")
    n2w = calib(f"vehicle-side/calib/novatel_to_world/{veh_frame_id}.json")
    v2w = calib(
        f"infrastructure-side/calib/virtuallidar_to_world/{inf_frame_id}.json")
    out = {
        "vehicle_pointcloud_path": info["vehicle_pointcloud_path"],
        "infrastructure_pointcloud_path": info["infrastructure_pointcloud_path"],
        "vehicle_lidar_pose": list(tf.world_to_pose(veh_lidar_to_world(l2n, n2w))),
        "infrastructure_lidar_pose": list(tf.world_to_pose(
            inf_lidar_to_world(v2w, info.get("system_error_offset")))),
        "cooperative_label_path": info["cooperative_label_path"],
        "raw_labels": True,
    }
    for side, key, fid in (("vehicle-side", "vehicle", veh_frame_id),
                           ("infrastructure-side", "infrastructure",
                            inf_frame_id)):
        img = info.get(f"{key}_image_path")
        l2c = calib(f"{side}/calib/lidar_to_camera/{fid}.json")
        intr = calib(f"{side}/calib/camera_intrinsic/{fid}.json")
        if img and l2c and intr:
            out[f"{key}_image_path"] = img
            out[f"{key}_camera2lidar"] = camera_to_lidar_matrix(l2c)
            out[f"{key}_cam_k"] = np.array(intr["cam_K"], np.float32).reshape(3, 3)
    return out


class DAIRDataset:
    """Index a DAIR-V2X split (raw or normalized) and produce fixed-shape
    numpy samples: ``ds[i]`` -> (batch, gt)."""

    def __init__(self, hypes: dict, root_dir: str, train: bool = True,
                 wild: WildSettings | None = None, seed: int = 0):
        margs = (hypes.get("model") or {}).get("args") or {}
        # the first vehicle / rsu ``cam`` block gives the camera inputs
        self.cam_cfg = next((margs[t]["cam"] for t in ("vehicle", "rsu")
                             if (margs.get(t) or {}).get("cam")), None)
        self.train = train
        self.root = root_dir
        self.wild = wild or WildSettings()
        self.seed = seed
        self.layout = SlotLayout(counts=(2, 0, 0))
        self.lidar_range = hypes["preprocess"]["cav_lidar_range"]
        self.max_points = int(hypes["preprocess"].get("max_points", 60000))
        self.max_num = int(hypes["postprocess"]["max_num"])
        fargs = hypes.get("fusion", {}).get("args", {})
        self.proj_first = bool(fargs.get("proj_first", True))
        self.clip_pc = bool(fargs.get("clip_pc", False))
        info_path = os.path.join(root_dir, "cooperative", "data_info.json")
        frames = _load_json(info_path) if os.path.isfile(info_path) else []
        self.frames = [f if "vehicle_lidar_pose" in f
                       else _dair_raw_frame(root_dir, f) for f in frames]

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx: int):
        info = self.frames[idx]
        veh_pose = info["vehicle_lidar_pose"]
        inf_pose = info["infrastructure_lidar_pose"]
        if self.wild.loc_error:  # the ego vehicle stays clean
            rng = np.random.default_rng((self.seed, idx))
            inf_pose = tf.add_pose_noise(inf_pose, rng, self.wild.xyz_std,
                                         self.wild.ryp_std)

        L, n = 2, self.max_points
        points = np.zeros((L, n, 4), np.float32)
        points_mask = np.zeros((L, n), bool)
        pairwise = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        pairwise_full = np.tile(np.eye(4, dtype=np.float32), (L, L, 1, 1))
        lidar_range = np.asarray(self.lidar_range, np.float32)
        transforms = []
        for slot, (pose, key) in enumerate(
                ((veh_pose, "vehicle_pointcloud_path"),
                 (inf_pose, "infrastructure_pointcloud_path"))):
            t_cav_ego = tf.pose_a_to_b(pose, veh_pose)
            transforms.append(t_cav_ego)
            if not self.proj_first:
                pairwise[slot] = t_cav_ego.astype(np.float32)
            path = os.path.join(self.root, info[key])
            if os.path.isfile(path):
                cnt = load_pcd_into(
                    path, points[slot],
                    transform=(t_cav_ego.astype(np.float32) if self.proj_first
                               else None),
                    lidar_range=lidar_range, ego_mask=0.0)
                points_mask[slot, :cnt] = True
        if self.clip_pc:  # drop x < 0 (the vehicle frame)
            points_mask &= ~(points[..., 0] < 0)
        if not self.proj_first:
            for i in range(L):
                for j in range(L):
                    pairwise_full[i, j] = np.linalg.solve(transforms[i],
                                                          transforms[j])

        boxes = np.zeros((self.max_num, 7), np.float32)
        classes = np.ones((self.max_num,), np.int32)
        mask = np.zeros((self.max_num,), bool)
        label_path = os.path.join(self.root, info["cooperative_label_path"])
        labels = _load_json(label_path) if os.path.isfile(label_path) else []
        i = 0
        if info.get("raw_labels"):
            world_to_lidar = np.linalg.inv(tf.pose_to_world(veh_pose))
            for obj in labels:
                if i >= self.max_num:
                    break
                pts8 = obj.get("world_8_points")
                if pts8 is None:
                    continue
                box = _world_8_points_to_box(pts8, world_to_lidar,
                                             self.lidar_range)
                if box is None:
                    continue
                boxes[i], mask[i] = box, True
                i += 1
            labels = []
        lr = self.lidar_range
        for obj in labels:
            if i >= self.max_num:
                break
            loc = obj["location"]
            yaw = float(obj.get("rotation", 0.0))
            ext = obj["extent"]  # half dims [l/2, w/2, h/2]
            o2l = tf.pose_a_to_b([loc[0], loc[1], loc[2], 0.0, np.degrees(yaw),
                                  0.0], veh_pose)
            cx, cy, cz = o2l[:3, 3]
            if not (lr[0] < cx < lr[3] and lr[1] < cy < lr[4]):
                continue
            yaw_ego = np.arctan2(o2l[1, 0], o2l[0, 0])
            boxes[i] = [cx, cy, cz, 2 * ext[2], 2 * ext[1], 2 * ext[0], yaw_ego]
            mask[i] = True
            i += 1

        batch = {"points": points, "points_mask": points_mask,
                 "agent_mask": np.array([True, True]), "pairwise_t": pairwise,
                 "pairwise_t_full": pairwise_full,
                 # the infrastructure flag on slot 1
                 "prior_encoding": np.array([[0, 0, 0], [0, 0, 1]], np.float32)}
        cam = self._load_cameras(info)
        if cam is not None:
            batch["cam_vehicle"] = cam
        gt = {"boxes": boxes, "mask": mask, "classes": classes}
        return batch, gt

    def _load_cameras(self, info):
        """One camera per slot from the raw calib chain
        (lidar_camera_intermediate_fusion_dataset.py:505-560): the image
        resized to ``final_dim`` and imagenet-normalized, cam_K, the
        camera -> lidar rotation and translation, identity post transforms
        (the reference resizes without touching post_rots: kept). None
        without a camera block or without any image on disk."""
        if self.cam_cfg is None:
            return None
        from PIL import Image

        from airv2x_tpu_torch.data.camera import normalize_img

        h, w = self.cam_cfg["data_aug_conf"]["final_dim"]
        L = 2
        imgs = np.zeros((L, 1, h, w, 3), np.float32)
        intr = np.broadcast_to(np.eye(3, dtype=np.float32), (L, 1, 3, 3)).copy()
        rots = intr.copy()
        trans = np.zeros((L, 1, 3), np.float32)
        found = False
        for slot, key in enumerate(("vehicle", "infrastructure")):
            img_rel = info.get(f"{key}_image_path")
            c2l = info.get(f"{key}_camera2lidar")
            cam_k = info.get(f"{key}_cam_k")
            if not img_rel or c2l is None or cam_k is None:
                continue
            path = os.path.join(self.root, img_rel)
            if not os.path.isfile(path):
                continue
            with Image.open(path) as img:
                imgs[slot, 0] = normalize_img(img.resize((w, h)))
            intr[slot, 0] = cam_k
            c2l = np.asarray(c2l, np.float32)
            rots[slot, 0] = c2l[:3, :3]
            trans[slot, 0] = c2l[:3, 3]
            found = True
        if not found:
            return None
        return {"imgs": imgs, "intrinsics": intr, "rots": rots, "trans": trans,
                "post_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                             (L, 1, 3, 3)).copy(),
                "post_trans": np.zeros((L, 1, 3), np.float32)}
