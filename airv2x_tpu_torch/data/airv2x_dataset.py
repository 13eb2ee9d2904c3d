"""The AirV2X on-disk dataset -> fixed-shape samples (counterpart of
airv2x_tpu/data/airv2x_dataset.py).

  * directory walk ``root/<scenario>/timestamp_*/agent_*/`` with
    ``metadata.pkl`` / ``objects.pkl`` pickles and lidar ``.pcd`` files;
  * ego choice: the first vehicle, or in training a seeded random vehicle,
    a pure function of (sample, epoch, seed);
  * per-type communication-range gating (vehicle / RSU 120 m, drone 180 m)
    and the nearest agents of each type up to its slot count;
  * wild settings: async latency (delayed frames of the other agents) and
    gaussian pose noise, drawn from ``np.random.default_rng((seed, epoch,
    idx))`` in the JAX package's order;
  * each agent's cloud projected into the ego frame when ``proj_first``,
    range-cropped and padded to the static ``SlotLayout``;
  * objects deduped by id (``objects.pkl`` is global), converted to
    ego-frame hwl boxes and padded to ``max_num``;
  * for each agent type with the ``cam`` modality, every chosen agent's
    cameras loaded and augmented (``data/camera.py``) and stacked per type
    into ``cam_<type>`` blocks over all slots; a BM2CP config's vehicle and
    rsu cameras (``img_params``) and drone camera (its flat LSS conf), each
    with the agent's LiDAR projected into them as ``depth_maps``;
  * for the seg task, the ego's dynamic and static BEV label maps.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

from airv2x_tpu_torch.data.camera import (
    load_agent_cam_inputs, load_agent_depth_maps, load_seg_labels,
    stack_cam_slots)
from airv2x_tpu_torch.data.pcd import load_pcd_into
from airv2x_tpu_torch.models.base import AGENT_TYPES, SlotLayout
from airv2x_tpu_torch.utils import transforms as tf

COM_RANGE = {"vehicle": 120.0, "rsu": 120.0, "drone": 180.0}
VALID_CLASSES = (1, 2, 3, 4, 5, 6)
EGO_MASK = 2.0  # points with |x| and |y| under this (m) hit the carrier


def _load_pickle(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def abs_world_pose(rel_pose, center_pose):
    """Sensor pose relative to its carrier -> world pose (elementwise sum)."""
    return [a + b for a, b in zip(rel_pose[:6], center_pose[:6])]


_CORNER_SIGNS = np.array(
    [[1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
     [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1]], dtype=np.float64)


def corner_to_center_hwl(corners: np.ndarray) -> np.ndarray:
    """(8, 3) corners -> 7-dof hwl box, in float32 and in the order of the
    JAX package's ``ops.geometry.corner_to_center``: the centre as the mean
    of corners 0, 3, 5, 6, the height as the mean vertical edge, length and
    width as the mean of four BEV edges, the yaw as the mean of four edge
    angles."""
    c = np.asarray(corners, np.float32)
    four = np.float32(4.0)
    xyz = (c[0] + c[3] + c[5] + c[6]) / four
    dz = c[4:, 2] - c[:4, 2]
    h = np.abs((dz[0] + dz[1] + dz[2] + dz[3]) / four)

    def edge(i, j):
        d = c[i, :2] - c[j, :2]
        return np.sqrt(d[0] * d[0] + d[1] * d[1])

    def angle(i, j):
        d = c[i, :2] - c[j, :2]
        return np.arctan2(d[1], d[0])

    l = (edge(0, 3) + edge(2, 1) + edge(4, 7) + edge(5, 6)) / four
    w = (edge(0, 1) + edge(2, 3) + edge(4, 5) + edge(6, 7)) / four
    theta = (angle(1, 2) + angle(0, 3) + angle(5, 6) + angle(4, 7)) / four
    return np.array([xyz[0], xyz[1], xyz[2], h, w, l, theta], np.float32)


def object_to_ego_box(obj: dict, ego_lidar_pose, lidar_range):
    """World object metadata -> 7-dof hwl box in the ego-lidar frame, or
    None when its centre lies outside the range in x or y."""
    loc = obj["location"]
    center = obj.get("center", [0, 0, 0])
    object_pose = [loc[0] + center[0], loc[1] + center[1], loc[2] + center[2],
                   loc[3], loc[4], loc[5]]
    obj2lidar = tf.pose_a_to_b(object_pose, ego_lidar_pose)
    corners = _CORNER_SIGNS * np.array(obj["extent"][:3])
    corners = corners @ obj2lidar[:3, :3].T + obj2lidar[:3, 3]
    box = corner_to_center_hwl(corners)
    x, y = box[0], box[1]
    if not (lidar_range[0] < x < lidar_range[3]
            and lidar_range[1] < y < lidar_range[4]):
        return None
    return box


@dataclass
class WildSettings:
    """Async latency and localization error (the reference's wild_setting)."""

    async_mode: bool = False
    async_overhead_ms: float = 100.0
    data_rate_hz: float = 10.0
    loc_error: bool = False
    xyz_std: float = 0.2
    ryp_std: float = 0.2


class AirV2XDataset:
    """Index an on-disk AirV2X split and produce fixed-shape numpy samples:
    ``ds[i]`` or ``ds.__getitem__(i, epoch=e)`` -> (batch, gt)."""

    def __init__(self, hypes: dict, split_dir: str, train: bool = True,
                 wild: WildSettings | None = None, seed: int = 0):
        self.train = train
        self.wild = wild or WildSettings()
        self.seed = seed
        margs = hypes["model"]["args"]
        core = hypes["model"]["core_method"].lower()
        fusion = hypes.get("fusion", {})
        # BM2CP samples: the veh / rsu camera confs sit under img_params, the
        # drone's is the flat LSS conf, and each type with a grid_conf gets
        # its LiDAR projected into its cameras (depth_maps)
        self.bm2cp = "bm2cp" in str(fusion.get("core_method", "")).lower() + core
        # the types that consume images: their LSS augmentation confs and
        # whether their images carry the depth channel
        self.cam_confs, self.cam_depth, self.cam_grid = {}, {}, {}
        for t in AGENT_TYPES:
            tcfg = margs.get(t)
            if not isinstance(tcfg, dict):
                continue
            if "cam" in tcfg.get("modalities", []):
                cam = tcfg["cam"]
            elif self.bm2cp and "img_params" in tcfg:
                cam = tcfg["img_params"]
            elif self.bm2cp and "grid_conf" in tcfg and "data_aug_conf" in tcfg:
                cam = tcfg
            else:
                continue
            self.cam_confs[t] = cam["data_aug_conf"]
            self.cam_depth[t] = bool(cam.get("use_depth_gt")
                                     or cam.get("depth_supervision"))
            if "grid_conf" in cam:
                self.cam_grid[t] = cam["grid_conf"]
        self.layout = SlotLayout.from_args(margs)
        self.lidar_range = hypes["preprocess"]["cav_lidar_range"]
        self.max_points = int(hypes["preprocess"].get("max_points", 60000))
        self.max_num = int(hypes["postprocess"]["max_num"])
        self.proj_first = bool(fusion.get("args", {}).get("proj_first", True))
        # K-frame temporal samples for SCOPE / How2comm
        self.frames = int(
            fusion.get("args", {}).get("num_sweep_frames", 0)
            or (margs.get("temporal_fusion", {}).get("frames", 0)
                if any(k in core for k in ("scope", "how2comm")) else 0)
            or 1)
        self.load_seg = hypes.get("task", margs.get("task", "det")) == "seg"

        self.samples = []  # (scenario path, sorted timestamp dirs, t index)
        if os.path.isdir(split_dir):
            for scen in sorted(os.listdir(split_dir)):
                spath = os.path.join(split_dir, scen)
                if not os.path.isdir(spath):
                    continue
                stamps = sorted(
                    d for d in os.listdir(spath)
                    if d.startswith("timestamp_")
                    and os.path.isdir(os.path.join(spath, d)))
                self.samples.extend((spath, stamps, i) for i in range(len(stamps)))

    def __len__(self):
        return len(self.samples)

    def _agents_at(self, spath, stamp):
        tdir = os.path.join(spath, stamp)
        agents = {}
        for d in sorted(os.listdir(tdir)):
            apath = os.path.join(tdir, d)
            if not os.path.isdir(apath) or not d.startswith("agent_"):
                continue
            meta_path = os.path.join(apath, "metadata.pkl")
            if not os.path.isfile(meta_path):
                continue
            meta = _load_pickle(meta_path)
            lidars = sorted(
                os.path.join(apath, f) for f in os.listdir(apath)
                if f.endswith(".pcd") and "lidar" in f and "semantic" not in f)
            agents[int(d.split("_")[1])] = {
                "path": apath, "meta": meta, "type": meta["agent_type"],
                "lidar": lidars[0] if lidars else None}
        objs_path = os.path.join(tdir, "objects.pkl")
        objects = _load_pickle(objs_path) if os.path.isfile(objs_path) else {}
        objects = {k: v for k, v in objects.items()
                   if v.get("class") in VALID_CLASSES}
        return agents, objects

    @staticmethod
    def _lidar_world_pose(meta):
        return abs_world_pose(meta["lidar"]["lidar_pose"],
                              meta["odometry"]["ego_pos"])

    def _delay_stamp(self, idx):
        """Index of the delayed frame of the non-ego agents (async mode)."""
        if not self.wild.async_mode:
            return idx
        frames = int(round(
            self.wild.async_overhead_ms / 1000.0 * self.wild.data_rate_hz))
        return max(idx - frames, 0)

    def __getitem__(self, idx: int, epoch: int = 0):
        spath, stamps, t = self.samples[idx]
        rng = np.random.default_rng((self.seed, epoch, idx))
        agents, objects = self._agents_at(spath, stamps[t])
        vehicles = [k for k, a in agents.items() if a["type"] == "vehicle"]
        if not vehicles:
            raise ValueError(f"no vehicle agent in {spath}/{stamps[t]}")
        ego_id = (int(rng.choice(vehicles)) if self.train and len(vehicles) > 1
                  else vehicles[0])
        if self.frames <= 1:
            batch, gt, _ = self._assemble(spath, stamps, t, ego_id, rng,
                                          preloaded=(agents, objects))
            return batch, gt

        # K frames, oldest first, one ego; frame k's points stay in k's ego
        # frame and ``history_t`` carries the k -> current ego transform;
        # the labels are the current (last) frame's
        frames, poses = [], []
        for k in [max(t - k, 0) for k in range(self.frames - 1, -1, -1)]:
            b, gt, pose = self._assemble(spath, stamps, k, ego_id, rng)
            frames.append(b)
            poses.append(pose)
        batch = {key: np.stack([f[key] for f in frames])
                 for key in ("points", "points_mask", "agent_mask")}
        for key, v in frames[-1].items():
            if key not in batch:
                batch[key] = v
        batch["history_t"] = np.stack(
            [tf.pose_a_to_b(p, poses[-1]).astype(np.float32) for p in poses])
        return batch, gt

    def _assemble(self, spath, stamps, t, ego_id, rng, preloaded=None):
        agents, objects = preloaded or self._agents_at(spath, stamps[t])
        if ego_id not in agents:  # the ego is absent in a historical frame
            ego_id = [k for k, a in agents.items() if a["type"] == "vehicle"][0]
        ego = agents[ego_id]
        ego_pose = self._lidar_world_pose(ego["meta"])

        td = self._delay_stamp(t)
        agents_delay = self._agents_at(spath, stamps[td])[0] if td != t else agents

        # distance and comm-range gating, the nearest of each type
        chosen = {tname: [] for tname in AGENT_TYPES}
        for aid, a in agents.items():
            src = agents_delay.get(aid, a) if aid != ego_id else a
            pose = self._lidar_world_pose(src["meta"])
            d = float(np.hypot(pose[0] - ego_pose[0], pose[1] - ego_pose[1]))
            if aid != ego_id and d > COM_RANGE[a["type"]]:
                continue
            chosen[a["type"]].append((0.0 if aid == ego_id else d, aid, src))
        for tname in AGENT_TYPES:
            chosen[tname].sort(key=lambda x: x[0])
            chosen[tname] = chosen[tname][:self.layout.counts[
                AGENT_TYPES.index(tname)]]

        L, n = self.layout.total, self.max_points
        points = np.zeros((L, n, 4), np.float32)
        points_mask = np.zeros((L, n), bool)
        agent_mask = np.zeros((L,), bool)
        prior = np.zeros((L, 3), np.float32)
        pairwise = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        lidar_range = np.asarray(self.lidar_range, np.float32)
        cam_slots = {tname: {} for tname in self.cam_confs}
        ego_dir = None
        for tname in AGENT_TYPES:
            sl = self.layout.slots(tname)
            for j, (_, aid, a) in enumerate(chosen[tname]):
                slot = sl.start + j
                agent_mask[slot] = True
                pose = self._lidar_world_pose(a["meta"])
                if self.wild.loc_error and aid != ego_id:
                    pose = tf.add_pose_noise(pose, rng, self.wild.xyz_std,
                                             self.wild.ryp_std)
                t_cav_ego64 = tf.pose_a_to_b(pose, ego_pose)
                t_cav_ego = t_cav_ego64.astype(np.float32)
                pairwise[slot] = t_cav_ego
                # prior_encoding = [velocity / 30, time delay, is RSU]
                prior[slot, 0] = float(
                    a["meta"]["odometry"].get("ego_speed", 0.0)) / 30.0
                prior[slot, 1] = float(t - self._delay_stamp(t))
                prior[slot, 2] = float(tname == "rsu")
                if aid == ego_id:
                    ego_dir = a["path"]
                cnt = 0
                if a["lidar"] is not None:
                    cnt = load_pcd_into(
                        a["lidar"], points[slot],
                        transform=t_cav_ego if self.proj_first else None,
                        lidar_range=lidar_range, ego_mask=EGO_MASK)
                    points_mask[slot, :cnt] = True
                    if cnt == 0:
                        # the reference's empty-cloud fallback: one dummy
                        # point at the grid centre
                        points[slot, 0] = 0.0
                        points_mask[slot, 0] = True
                if tname in self.cam_confs:
                    cam = load_agent_cam_inputs(
                        a["path"], a["meta"], tname, self.cam_confs[tname],
                        self.train, rng, with_depth=self.cam_depth[tname])
                    if cam is not None and self.bm2cp and tname in self.cam_grid:
                        # the LiDAR projected into the cameras; a drone has no
                        # LiDAR: all -1, the predicted depth fills in
                        dm = load_agent_depth_maps(
                            a["path"], a["meta"], tname,
                            points[slot, :cnt, :3] if cnt
                            else np.zeros((0, 3), np.float32),
                            self.cam_grid[tname],
                            tuple(self.cam_confs[tname]["final_dim"]),
                            cav_to_points=t_cav_ego64 if self.proj_first else None)
                        if dm is not None:
                            cam["depth_maps"] = dm
                    if cam is not None:
                        cam_slots[tname][slot] = cam

        eye = np.eye(4, dtype=np.float32)
        pairwise_batch = np.tile(eye, (L, 1, 1)) if self.proj_first else pairwise
        pairwise_full = np.tile(eye, (L, L, 1, 1))
        if not self.proj_first:
            for i in range(L):
                for j in range(L):
                    pairwise_full[i, j] = np.linalg.solve(pairwise[i], pairwise[j])

        boxes = np.zeros((self.max_num, 7), np.float32)
        classes = np.zeros((self.max_num,), np.int32)
        mask = np.zeros((self.max_num,), bool)
        i = 0
        for obj in objects.values():
            if i >= self.max_num:
                break
            box = object_to_ego_box(obj, ego_pose, self.lidar_range)
            if box is None:
                continue
            boxes[i], classes[i], mask[i] = box, int(obj["class"]), True
            i += 1

        batch = {"points": points, "points_mask": points_mask,
                 "agent_mask": agent_mask, "pairwise_t": pairwise_batch,
                 "pairwise_t_full": pairwise_full, "prior_encoding": prior}
        # per type (L, Ncam, fH, fW, C) blocks, zero outside its agents' slots
        for tname, slots_data in cam_slots.items():
            if slots_data:
                batch[f"cam_{tname}"] = stack_cam_slots(slots_data, L)
        if self.load_seg and ego_dir is not None:
            dyn, sta = load_seg_labels(ego_dir)
            if dyn is not None:
                batch["dynamic_seg_label"] = dyn.astype(np.int32)
            if sta is not None:
                batch["static_seg_label"] = sta.astype(np.int32)
        gt = {"boxes": boxes, "mask": mask, "classes": classes}
        return batch, gt, ego_pose
