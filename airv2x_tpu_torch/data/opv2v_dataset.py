"""The OPV2V on-disk dataset -> fixed-shape samples (counterpart of
airv2x_tpu/data/opv2v_dataset.py, the LiDAR branch).

  * directory walk ``root/<scenario>/<cav_id>/<timestamp>.yaml`` (per-frame
    metadata: ``lidar_pose`` [x y z roll yaw pitch], the ``vehicles`` gt
    dict with location / angle / center / extent, ``ego_speed``) plus
    ``<timestamp>.pcd`` clouds; the ego is the lowest cav id, the stamps are
    the first cav's sorted ``.yaml`` files without the ``additional`` ones;
  * wild settings: gaussian localization noise on the non-ego poses, drawn
    from ``np.random.default_rng((seed, epoch, idx))`` in the JAX package's
    order;
  * the 70 m communication-range gate and the nearest ``max_cav`` cavs;
  * each cloud projected into the ego frame when ``proj_first`` (else
    ``pairwise_t`` / ``pairwise_t_full`` carry the transforms), the 2 m ego
    mask, the range crop, padded to the vehicle-only ``SlotLayout``;
  * ``prior_encoding`` [:, 0] = the cav's ``ego_speed``; the gt is the union
    of the chosen cavs' ``vehicles``, deduplicated by id;
  * for SCOPE / How2comm, K-frame temporal samples: ``points``,
    ``points_mask`` and ``agent_mask`` stacked over the frames (oldest
    first, the current last), ``history_t`` (K, 4, 4) each frame's ego pose
    in the current ego frame, every other key (``pairwise_t_full``
    included) the current frame's, and the current frame's gt.

  * where the model's vehicle config gives the ``cam`` modality, each
    chosen cav's four cameras (``data/camera.py:load_opv2v_cam_inputs``)
    stacked into ``cam_vehicle``. As in the JAX package, the ``*_bm2cp``
    YAMLs (``img_params`` at the top of the model args) load no camera,
    and no OPV2V sample carries ``depth_maps`` (ROADMAP §3).
  * with ``use_radar`` (V2X-R), each chosen cav's ``<timestamp>_radar.pcd``
    into an (L, max_points // 4, 4) buffer through the same transform and
    range crop, without the ego mask: ``radar_points`` /
    ``radar_points_mask``, the current frame's in a temporal sample. The
    configs' ``fusion.args.use_radar`` is read by neither package: the
    caller passes ``use_radar`` (ROADMAP §3).
  * for MDD's training samples (an ``mdd`` model, ``train``), each LiDAR
    point's weather label read with the cloud: ``de_points_mask`` is
    ``points_mask`` where the label is 0 (the real points; the rest are
    simulated weather noise), the current frame's in a temporal sample.
"""

from __future__ import annotations

import os

import numpy as np
import yaml

from airv2x_tpu_torch.data.airv2x_dataset import (
    _CORNER_SIGNS, WildSettings, corner_to_center_hwl)
from airv2x_tpu_torch.data.camera import load_opv2v_cam_inputs, stack_cam_slots
from airv2x_tpu_torch.data.pcd import load_pcd_into, load_pcd_label_into
from airv2x_tpu_torch.models.base import SlotLayout
from airv2x_tpu_torch.utils import transforms as tf

COM_RANGE = 70.0  # OPV2V's communication range (m)
EGO_MASK = 2.0  # points with |x| and |y| under this (m) hit the carrier


def _load_yaml(path):
    with open(path) as f:
        return yaml.safe_load(f)


def object_to_ego_box(obj: dict, ego_lidar_pose, lidar_range):
    """An OPV2V ``vehicles`` entry -> 7-dof hwl box in the ego-lidar frame,
    or None when its centre lies outside the range in x or y."""
    loc = obj["location"]
    ang = obj["angle"]  # [roll, yaw, pitch]
    center = obj.get("center", [0, 0, 0])
    object_pose = [loc[0] + center[0], loc[1] + center[1], loc[2] + center[2],
                   ang[0], ang[1], ang[2]]
    obj2lidar = tf.pose_a_to_b(object_pose, ego_lidar_pose)
    corners = _CORNER_SIGNS * np.array(obj["extent"][:3])
    corners = corners @ obj2lidar[:3, :3].T + obj2lidar[:3, 3]
    box = corner_to_center_hwl(corners)
    x, y = box[0], box[1]
    if not (lidar_range[0] < x < lidar_range[3]
            and lidar_range[1] < y < lidar_range[4]):
        return None
    return box


def temporal_frames(hypes: dict) -> int:
    """Frames per sample: ``fusion.args.num_sweep_frames``, or for SCOPE /
    How2comm ``model.args.temporal_fusion.frames``, else 1."""
    core = str(hypes.get("model", {}).get("core_method", "")).lower()
    margs = hypes.get("model", {}).get("args", {})
    return int(
        hypes.get("fusion", {}).get("args", {}).get("num_sweep_frames", 0)
        or (margs.get("temporal_fusion", {}).get("frames", 0)
            if any(k in core for k in ("scope", "how2comm")) else 0)
        or 1)


def pairwise_over_frames(batch: dict) -> dict:
    """A collated temporal batch (``points`` (B, T, L, N, 4)) with the
    current frame's ``pairwise_t_full`` (B, L, L, 4, 4) repeated over the
    frames, (B, T, L, L, 4, 4), the layout SCOPE reads (``[:, -1]`` is the
    current frame's). The dataset keeps the JAX package's per-sample layout,
    which gives the pairwise transforms of the current frame only; under
    ``proj_first`` every one is the identity, so the repetition is exact.
    Works on numpy arrays and on tensors; other batches pass through."""
    pts, pw = batch["points"], batch["pairwise_t_full"]
    if pts.ndim != 5 or pw.ndim != 5:
        return batch
    t = pts.shape[1]
    if isinstance(pw, np.ndarray):
        rep = np.repeat(pw[:, None], t, axis=1)
    else:
        rep = pw[:, None].expand(-1, t, -1, -1, -1, -1).contiguous()
    return dict(batch, pairwise_t_full=rep)


class OPV2VDataset:
    """Index an OPV2V-format split and produce fixed-shape numpy samples:
    ``ds[i]`` or ``ds.__getitem__(i, epoch=e)`` -> (batch, gt)."""

    def __init__(self, hypes: dict, split_dir: str, train: bool = True,
                 use_radar: bool = False, seed: int = 0,
                 wild: WildSettings | None = None):
        self.train = train
        self.use_radar = use_radar
        self.seed = seed
        self.wild = wild or WildSettings()
        max_cav = hypes["train_params"]["max_cav"]
        if isinstance(max_cav, dict):
            max_cav = sum(max_cav.values())
        self.layout = SlotLayout(counts=(int(max_cav), 0, 0))
        self.lidar_range = hypes["preprocess"]["cav_lidar_range"]
        self.max_points = int(hypes["preprocess"].get("max_points", 60000))
        self.max_num = int(hypes["postprocess"]["max_num"])
        self.proj_first = bool(
            hypes.get("fusion", {}).get("args", {}).get("proj_first", True))
        margs = hypes.get("model", {}).get("args", {})
        veh = margs.get("vehicle") if isinstance(margs.get("vehicle"), dict) else {}
        # the camera branch: the vehicles' four cameras where the model's
        # vehicle config gives the cam modality
        self.cam_conf = (veh.get("cam", {}).get("data_aug_conf")
                         if "cam" in veh.get("modalities", []) else None)
        core = str(hypes.get("model", {}).get("core_method", "")).lower()
        self.with_de = "mdd" in core and train
        self.frames = temporal_frames(hypes)

        self.samples = []  # (scenario path, sorted cav ids, stamps, t index)
        if os.path.isdir(split_dir):
            for scen in sorted(os.listdir(split_dir)):
                spath = os.path.join(split_dir, scen)
                if not os.path.isdir(spath):
                    continue
                cavs = sorted(d for d in os.listdir(spath)
                              if os.path.isdir(os.path.join(spath, d)))
                if not cavs:
                    continue
                stamps = sorted(
                    f[:-5] for f in os.listdir(os.path.join(spath, cavs[0]))
                    if f.endswith(".yaml") and "additional" not in f)
                self.samples.extend((spath, cavs, stamps, i)
                                    for i in range(len(stamps)))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx: int, epoch: int = 0):
        spath, cavs, stamps, ti = self.samples[idx]
        rng = np.random.default_rng((self.seed, epoch, idx))
        if self.frames <= 1:
            batch, gt, _ = self._assemble(spath, cavs, stamps[ti], rng)
            return batch, gt

        # oldest -> current; frame k's points stay in k's ego frame and
        # history_t carries the k -> current ego transform
        frames, poses = [], []
        for k in [max(ti - k, 0) for k in range(self.frames - 1, -1, -1)]:
            b, gt, pose = self._assemble(spath, cavs, stamps[k], rng)
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

    def _assemble(self, spath, cavs, stamp, rng):
        metas = {}
        for cav in cavs:
            ypath = os.path.join(spath, cav, f"{stamp}.yaml")
            if os.path.isfile(ypath):
                metas[cav] = _load_yaml(ypath)
        ego_id = cavs[0]
        ego_pose = metas[ego_id]["lidar_pose"]

        if self.wild.loc_error:
            for cav in cavs[1:]:
                if cav in metas:
                    metas[cav] = dict(metas[cav])
                    metas[cav]["lidar_pose"] = tf.add_pose_noise(
                        metas[cav]["lidar_pose"], rng, self.wild.xyz_std,
                        self.wild.ryp_std)

        # the comm-range gate, then the nearest cavs
        chosen = [(0.0, ego_id)]
        for cav in cavs[1:]:
            if cav not in metas:
                continue
            pose = metas[cav]["lidar_pose"]
            d = float(np.hypot(pose[0] - ego_pose[0], pose[1] - ego_pose[1]))
            if d <= COM_RANGE:
                chosen.append((d, cav))
        chosen.sort(key=lambda x: x[0])
        chosen = chosen[:self.layout.total]

        L, n = self.layout.total, self.max_points
        points = np.zeros((L, n, 4), np.float32)
        points_mask = np.zeros((L, n), bool)
        clean = np.ones((L, n), bool)
        radar_points = np.zeros((L, n // 4, 4), np.float32)
        radar_mask = np.zeros((L, n // 4), bool)
        agent_mask = np.zeros((L,), bool)
        prior = np.zeros((L, 3), np.float32)
        pairwise = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
        pairwise_full = np.tile(np.eye(4, dtype=np.float32), (L, L, 1, 1))
        lidar_range = np.asarray(self.lidar_range, np.float32)
        t_cav_ego_all = []
        cam_slots = {}
        for slot, (_, cav) in enumerate(chosen):
            agent_mask[slot] = True
            t_cav_ego = tf.pose_a_to_b(metas[cav]["lidar_pose"], ego_pose)
            t_cav_ego_all.append(t_cav_ego)
            if not self.proj_first:
                pairwise[slot] = t_cav_ego.astype(np.float32)
            prior[slot, 0] = float(metas[cav].get("ego_speed", 0.0))
            pcd = os.path.join(spath, cav, f"{stamp}.pcd")
            if os.path.isfile(pcd):
                kw = dict(transform=(t_cav_ego.astype(np.float32)
                                     if self.proj_first else None),
                          lidar_range=lidar_range, ego_mask=EGO_MASK)
                cnt = (load_pcd_label_into(pcd, points[slot], clean[slot], **kw)
                       if self.with_de else load_pcd_into(pcd, points[slot], **kw))
                points_mask[slot, :cnt] = True
            if self.cam_conf is not None:
                cam = load_opv2v_cam_inputs(os.path.join(spath, cav), stamp,
                                            metas[cav], self.cam_conf,
                                            self.train, rng)
                if cam is not None:
                    cam_slots[slot] = cam
            rpcd = os.path.join(spath, cav, f"{stamp}_radar.pcd")
            if self.use_radar and os.path.isfile(rpcd):
                cnt = load_pcd_into(
                    rpcd, radar_points[slot],
                    transform=(t_cav_ego.astype(np.float32) if self.proj_first
                               else None),
                    lidar_range=lidar_range, ego_mask=0.0)
                radar_mask[slot, :cnt] = True
        if not self.proj_first:
            for i, t_i in enumerate(t_cav_ego_all):
                for j, t_j in enumerate(t_cav_ego_all):
                    pairwise_full[i, j] = np.linalg.solve(t_i, t_j)

        boxes = np.zeros((self.max_num, 7), np.float32)
        classes = np.ones((self.max_num,), np.int32)
        mask = np.zeros((self.max_num,), bool)
        seen = set()
        i = 0
        for _, cav in chosen:
            for oid, obj in (metas[cav].get("vehicles") or {}).items():
                if oid in seen or i >= self.max_num:
                    continue
                seen.add(oid)
                box = object_to_ego_box(obj, ego_pose, self.lidar_range)
                if box is None:
                    continue
                boxes[i], mask[i] = box, True
                i += 1

        batch = {"points": points, "points_mask": points_mask,
                 "agent_mask": agent_mask, "pairwise_t": pairwise,
                 "pairwise_t_full": pairwise_full, "prior_encoding": prior}
        if self.use_radar:
            batch["radar_points"] = radar_points
            batch["radar_points_mask"] = radar_mask
        if self.with_de:
            batch["de_points_mask"] = points_mask & clean
        if cam_slots:
            batch["cam_vehicle"] = stack_cam_slots(cam_slots, L)
        gt = {"boxes": boxes, "mask": mask, "classes": classes}
        return batch, gt, ego_pose
