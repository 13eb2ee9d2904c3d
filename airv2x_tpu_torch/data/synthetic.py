"""Synthetic multi-agent LiDAR scenes, their camera inputs and labelled
training batches (copy of airv2x_tpu/data/synthetic.py ``make_scene``,
``add_camera_inputs``, ``rasterize_seg_labels``, ``make_batch`` and
``bm2cp_airv2x_batch``).

numpy, seeded by the caller's ``np.random.Generator``: the same seed gives
bit-identical scene arrays to the JAX package's generator, so both packages
can be fed one batch. ``make_batch`` attaches anchor targets
(``ops/anchors.py:assign_targets``, run on ``device``) and rasterized seg
labels; ``batch_to_torch`` moves a batch, nested ``labels`` included, onto
the device.
"""

from __future__ import annotations

import numpy as np
import torch

from airv2x_tpu_torch.models.base import AGENT_TYPES, SlotLayout
from airv2x_tpu_torch.ops.anchors import assign_targets
from airv2x_tpu_torch.utils.device import resolve_device


def _box_surface_points(rng, box, n):
    """Sample n points on the vertical faces + top of an hwl box."""
    x, y, z, h, w, l, yaw = box
    # local frame: l along x, w along y, h along z
    u = rng.uniform(-0.5, 0.5, size=(n, 2))
    face = rng.integers(0, 5, size=n)
    pts = np.zeros((n, 3))
    pts[:, 0] = np.where(face == 0, 0.5, np.where(face == 1, -0.5, u[:, 0])) * l
    pts[:, 1] = np.where(face == 2, 0.5, np.where(face == 3, -0.5, u[:, 1])) * w
    zu = rng.uniform(-0.5, 0.5, size=n)
    pts[:, 2] = np.where(face == 4, 0.5, zu) * h
    c, s = np.cos(yaw), np.sin(yaw)
    rx = c * pts[:, 0] - s * pts[:, 1] + x
    ry = s * pts[:, 0] + c * pts[:, 1] + y
    rz = pts[:, 2] + z
    return np.stack([rx, ry, rz], axis=-1)


def make_scene(
    rng: np.random.Generator,
    layout: SlotLayout,
    *,
    num_objects: int = 12,
    num_agents: dict | None = None,
    points_per_agent: int = 8192,
    lidar_range=(-140.8, -40, -3, 140.8, 40, 1),
    max_boxes: int = 100,
    pts_per_box: int = 120,
    radar_points_per_agent: int = 0,
):
    """Build one sample. Returns (batch_arrays, gt dict) — all numpy.

    ``radar_points_per_agent > 0`` adds a sparse 4D-radar cloud per agent
    (``radar_points`` / ``radar_points_mask``): an eighth of the agent's
    points (at most that many), jittered by N(0, 0.15) m. Its draws come
    after every other draw, so the rest of a seeded scene stays the same."""
    num_agents = num_agents or {"vehicle": 2, "rsu": 1, "drone": 1}
    L = layout.total
    n = points_per_agent

    xr = (lidar_range[0] * 0.7, lidar_range[3] * 0.7)
    yr = (lidar_range[1] * 0.7, lidar_range[4] * 0.7)

    boxes = np.zeros((max_boxes, 7), np.float32)
    classes = np.zeros((max_boxes,), np.int32)
    k = min(num_objects, max_boxes)
    boxes[:k, 0] = rng.uniform(*xr, k)
    boxes[:k, 1] = rng.uniform(*yr, k)
    boxes[:k, 2] = rng.uniform(-1.2, -0.8, k)
    boxes[:k, 3] = rng.uniform(1.4, 1.8, k)  # h
    boxes[:k, 4] = rng.uniform(1.5, 1.9, k)  # w
    boxes[:k, 5] = rng.uniform(3.5, 4.5, k)  # l
    boxes[:k, 6] = rng.uniform(-np.pi, np.pi, k)
    classes[:k] = rng.integers(1, 7, k)
    box_mask = np.arange(max_boxes) < k

    # agent viewpoints (ego-frame xy) per type
    agent_pos = np.zeros((L, 2), np.float32)
    agent_mask = np.zeros((L,), bool)
    prior = np.zeros((L, 3), np.float32)
    for t in AGENT_TYPES:
        sl = layout.slots(t)
        cnt = min(num_agents.get(t, 0), sl.stop - sl.start)
        for j in range(cnt):
            slot = sl.start + j
            agent_mask[slot] = True
            if t == "vehicle" and j == 0:
                agent_pos[slot] = 0.0  # ego
            else:
                agent_pos[slot, 0] = rng.uniform(*xr)
                agent_pos[slot, 1] = rng.uniform(*yr)
            prior[slot, 0] = rng.uniform(0, 20)  # velocity
            prior[slot, 1] = 0.0  # time delay
            prior[slot, 2] = float(t == "rsu")

    points = np.zeros((L, n, 4), np.float32)
    points_mask = np.zeros((L, n), bool)
    com_range = {"vehicle": 120.0, "rsu": 120.0, "drone": 180.0}
    for slot in range(L):
        if not agent_mask[slot]:
            continue
        t = next(
            tt for tt in AGENT_TYPES
            if layout.slots(tt).start <= slot < layout.slots(tt).stop
        )
        buf = []
        for b in range(k):
            d = np.linalg.norm(boxes[b, :2] - agent_pos[slot])
            if d > com_range[t]:
                continue
            density = max(0.15, min(1.0, 40.0 / max(d, 1.0)))
            m = max(4, int(pts_per_box * density * rng.uniform(0.5, 1.0)))
            buf.append(_box_surface_points(rng, boxes[b], m))
        n_ground = n // 4
        gx = rng.uniform(lidar_range[0], lidar_range[3], n_ground)
        gy = rng.uniform(lidar_range[1], lidar_range[4], n_ground)
        gz = rng.uniform(-2.0, -1.8, n_ground)
        buf.append(np.stack([gx, gy, gz], axis=-1))
        pts = np.concatenate(buf, axis=0)
        if len(pts) > n:
            pts = pts[rng.permutation(len(pts))[:n]]
        m = len(pts)
        points[slot, :m, :3] = pts
        points[slot, :m, 3] = rng.uniform(0, 1, m)
        points_mask[slot, :m] = True

    pairwise_t = np.broadcast_to(np.eye(4, dtype=np.float32), (L, 4, 4)).copy()
    pairwise_t_full = np.broadcast_to(
        np.eye(4, dtype=np.float32), (L, L, 4, 4)
    ).copy()

    batch = {
        "points": points,
        "points_mask": points_mask,
        "agent_mask": agent_mask,
        "pairwise_t": pairwise_t,
        "pairwise_t_full": pairwise_t_full,
        "prior_encoding": prior,
    }
    if radar_points_per_agent > 0:
        nr = radar_points_per_agent
        radar = np.zeros((L, nr, 4), np.float32)
        radar_mask = np.zeros((L, nr), bool)
        for slot in range(L):
            src = points_mask[slot].nonzero()[0]
            if not agent_mask[slot] or len(src) == 0:
                continue
            take = min(nr, max(1, len(src) // 8))
            sel = rng.choice(src, take, replace=len(src) < take)
            radar[slot, :take] = points[slot, sel]
            radar[slot, :take, :3] += rng.normal(0, 0.15, (take, 3))
            radar_mask[slot, :take] = True
        batch["radar_points"] = radar
        batch["radar_points_mask"] = radar_mask
    gt = {"boxes": boxes, "mask": box_mask, "classes": classes}
    return batch, gt


def add_camera_inputs(
    batch: dict,
    layout: SlotLayout,
    rng: np.random.Generator,
    *,
    img_hw=(64, 96),
    ncam={"vehicle": 2, "rsu": 2, "drone": 1},
    with_depth: bool = True,
):
    """Attach per-type synthetic camera inputs ``cam_<type>`` to a scene:
    imgs (L, Ncam, H, W, 3[+1]) over all L slots, with plausible intrinsics
    and forward-looking camera -> agent extrinsics; the depth channel holds
    5-45 m, so gt-depth binning works. The draws follow the JAX package's
    order, so one seed gives the same arrays in both packages."""
    L = layout.total
    h, w = img_hw
    for t in AGENT_TYPES:
        if layout.counts[AGENT_TYPES.index(t)] == 0:
            continue
        n = ncam[t]
        c = 4 if with_depth else 3
        imgs = rng.uniform(0, 1, (L, n, h, w, c)).astype(np.float32)
        if with_depth:
            imgs[..., 3] = rng.uniform(5, 45, (L, n, h, w))
        intr = np.zeros((L, n, 3, 3), np.float32)
        intr[..., 0, 0] = w * 0.8
        intr[..., 1, 1] = w * 0.8
        intr[..., 0, 2] = w / 2
        intr[..., 1, 2] = h / 2
        intr[..., 2, 2] = 1.0
        rots = np.zeros((L, n, 3, 3), np.float32)
        # camera looking forward: x_img -> -y_agent, y_img -> -z_agent,
        # z_img -> x_agent
        rots[..., 0, 2] = 1.0
        rots[..., 1, 0] = -1.0
        rots[..., 2, 1] = -1.0
        trans = rng.uniform(-2, 2, (L, n, 3)).astype(np.float32)
        post_rots = np.broadcast_to(np.eye(3, dtype=np.float32), (L, n, 3, 3)).copy()
        post_trans = np.zeros((L, n, 3), np.float32)
        batch[f"cam_{t}"] = {
            "imgs": imgs,
            "intrinsics": intr,
            "rots": rots,
            "trans": trans,
            "post_rots": post_rots,
            "post_trans": post_trans,
        }
    return batch


def camera_types(hypes: dict) -> list:
    """The agent types a config gives the camera modality."""
    margs = hypes["model"]["args"]
    return [t for t in AGENT_TYPES if isinstance(margs.get(t), dict)
            and "cam" in margs[t].get("modalities", [])]


def add_camera_batch(batch: dict, hypes: dict, layout: SlotLayout,
                     rng: np.random.Generator, **kw) -> dict:
    """Attach the ``cam_<type>`` blocks of a camera config to a (numpy)
    batch: each sample's ``add_camera_inputs`` at the first camera type's
    ``final_dim`` (``kw`` passes on, e.g. ``ncam``), drawn sample by sample
    (the JAX train CLI's order) and stacked leaf by leaf. A config without
    cameras leaves the batch as it is."""
    cams = camera_types(hypes)
    if not cams:
        return batch
    hw = tuple(hypes["model"]["args"][cams[0]]["cam"]["data_aug_conf"]["final_dim"])
    per = [add_camera_inputs({}, layout, rng, img_hw=hw, **kw)
           for _ in range(len(batch["points"]))]
    for key in per[0]:
        batch[key] = {k: np.stack([c[key][k] for c in per]) for k in per[0][key]}
    return batch


def rasterize_seg_labels(boxes, mask, classes, seg_hw: int, seg_res: float):
    """Rasterize gt boxes into a (seg_hw, seg_hw) dynamic class-id map (a BEV
    square centred on the ego, seg_res m/px): the synthetic stand-in for the
    dataset's segmentation labels."""
    half = seg_hw * seg_res / 2
    xs = (np.arange(seg_hw) + 0.5) * seg_res - half
    gx, gy = np.meshgrid(xs, xs, indexing="xy")  # (hw, hw) ego frame
    out = np.zeros((seg_hw, seg_hw), np.int32)
    for b, m, c in zip(boxes, mask, classes):
        if not m:
            continue
        cxy, yaw = b[:2], b[6]
        w_, l_ = b[4], b[5]
        ca, sa = np.cos(yaw), np.sin(yaw)
        rx = (gx - cxy[0]) * ca + (gy - cxy[1]) * sa
        ry = -(gx - cxy[0]) * sa + (gy - cxy[1]) * ca
        inside = (np.abs(rx) <= l_ / 2) & (np.abs(ry) <= w_ / 2)
        out[inside] = int(c)
    return out


def make_batch(
    rng: np.random.Generator,
    layout: SlotLayout,
    batch_size: int,
    anchors: np.ndarray | None = None,
    anchor_standup: np.ndarray | None = None,
    target_args: dict | None = None,
    seg_hw: int = 0,
    seg_res: float = 0.25,
    *,
    device="cuda",
    **scene_kw,
):
    """Stack ``batch_size`` scenes; with ``anchors``, attach anchor targets
    computed on ``device``; with ``seg_hw``, rasterized seg labels. Returns
    (batch, gt), all numpy, ``batch["labels"]`` a nested dict."""
    batches, gts = [], []
    for _ in range(batch_size):
        b, g = make_scene(rng, layout, **scene_kw)
        batches.append(b)
        gts.append(g)
    batch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    gt = {k: np.stack([g[k] for g in gts]) for k in gts[0]}

    if anchors is not None:
        dev = resolve_device(device)
        anc = torch.from_numpy(anchors).to(dev)
        standup = torch.from_numpy(anchor_standup).to(dev)
        tgts = [
            assign_targets(
                torch.from_numpy(g["boxes"]).to(dev),
                torch.from_numpy(g["mask"]).to(dev),
                torch.from_numpy(g["classes"]).to(dev),
                anc, standup,
                pos_threshold=target_args["pos_threshold"],
                neg_threshold=target_args["neg_threshold"],
            )
            for g in gts
        ]
        def stack(field):
            return np.stack([getattr(t, field).cpu().numpy() for t in tgts])

        batch["labels"] = {
            "pos_equal_one": stack("pos_equal_one"),
            "neg_equal_one": stack("neg_equal_one"),
            "targets": stack("targets"),
            "class_ids": stack("cls_labels"),
        }
    if seg_hw:
        dyn = np.stack([
            rasterize_seg_labels(g["boxes"], g["mask"], g["classes"],
                                 seg_hw, seg_res)
            for g in gts
        ])
        batch.setdefault("labels", {})
        batch["labels"]["dynamic_seg_label"] = dyn
        batch["labels"]["static_seg_label"] = np.zeros_like(dyn)
    return batch, gt


# perturb_poses' ranges: yaw in degrees, xy shift in metres, delay in frames.
PERTURB_MAX_DEG = 5.0
PERTURB_MAX_SHIFT = 3.0
PERTURB_MAX_DELAY = 3


def bm2cp_airv2x_batch(hypes: dict, rng: np.random.Generator,
                       batch_size: int = 1) -> dict:
    """A synthetic batch of the AirV2X BM2CP contract: per-slot points and,
    for each present type, one camera per slot; vehicle and rsu cameras
    carry ``depth_maps`` in bin units (-1 = unobserved, every third row),
    the drone is camera-only (with the metric depth as a 4th image channel
    under ``use_depth_gt``). The JAX package's draws, in its order."""
    args = hypes["model"]["args"]
    layout = SlotLayout.from_args(args)
    L, B, n_pts = layout.total, batch_size, 256
    lr = hypes["preprocess"]["cav_lidar_range"]
    pts = np.zeros((B, L, n_pts, 4), np.float32)
    pts[..., 0] = rng.uniform(lr[0], lr[3], (B, L, n_pts))
    pts[..., 1] = rng.uniform(lr[1], lr[4], (B, L, n_pts))
    pts[..., 2] = rng.uniform(max(lr[2], -2.5), min(lr[5], 0.5), (B, L, n_pts))
    pts[..., 3] = rng.uniform(0, 1, (B, L, n_pts))
    batch = {
        "points": pts,
        "points_mask": np.ones((B, L, n_pts), bool),
        "agent_mask": np.ones((B, L), bool),
        "pairwise_t_full": np.broadcast_to(
            np.eye(4, dtype=np.float32), (B, L, L, 4, 4)).copy(),
    }
    ncam = 1
    for t in AGENT_TYPES:
        if not layout.counts[AGENT_TYPES.index(t)]:
            continue
        cfg = args[t] if t == "drone" else args[t]["img_params"]
        h, w = cfg["data_aug_conf"]["final_dim"]
        nbins = int(cfg["grid_conf"]["ddiscr"][2])
        c = 4 if t == "drone" and cfg.get("use_depth_gt") else 3
        imgs = rng.uniform(0, 1, (B, L, ncam, h, w, c)).astype(np.float32)
        if c == 4:
            d_min, d_max = cfg["grid_conf"]["ddiscr"][:2]
            imgs[..., 3] = rng.uniform(d_min, d_max, (B, L, ncam, h, w))
        intr = np.zeros((B, L, ncam, 3, 3), np.float32)
        intr[..., 0, 0] = intr[..., 1, 1] = w * 0.8
        intr[..., 0, 2], intr[..., 1, 2] = w / 2, h / 2
        intr[..., 2, 2] = 1.0
        rots = np.zeros((B, L, ncam, 3, 3), np.float32)
        rots[..., 0, 2] = 1.0
        rots[..., 1, 0] = -1.0
        rots[..., 2, 1] = -1.0
        cam = {
            "imgs": imgs,
            "intrinsics": intr,
            "rots": rots,
            "trans": rng.uniform(-0.5, 0.5, (B, L, ncam, 3)).astype(np.float32),
            "post_rots": np.broadcast_to(
                np.eye(3, dtype=np.float32), (B, L, ncam, 3, 3)).copy(),
            "post_trans": np.zeros((B, L, ncam, 3), np.float32),
        }
        if t != "drone":
            dm = rng.integers(0, nbins, (B, L, ncam, h, w)).astype(np.float32)
            dm[:, :, :, ::3] = -1.0
            cam["depth_maps"] = dm
        batch[f"cam_{t}"] = cam
    return batch


def perturb_poses(batch: dict, rng: np.random.Generator) -> dict:
    """Give every non-ego agent slot of a numpy batch (``make_scene``'s, with
    or without a batch axis) a planar pose and a time delay, in place:
    ``pairwise_t`` a rotation about z of up to ``PERTURB_MAX_DEG`` degrees
    and an xy translation of up to ``PERTURB_MAX_SHIFT`` metres,
    ``prior_encoding[..., 1]`` an integer delay in [0, PERTURB_MAX_DELAY].
    Slot 0, the ego, keeps the identity and delay 0; the points stay as
    they are. Where the batch has ``pairwise_t_full``, each pair [i, j]
    becomes ``pairwise_t[i]^-1 pairwise_t[j]`` (agent j into agent i's
    frame), as ``AirV2XDataset`` builds it without ``proj_first``; no
    random number is drawn for it.

    ``make_scene``'s identity poses and zero delays leave the V2X-ViT
    warp, its ROI mask and its temporal encoding, and the pairwise warps of
    V2VNet and When2com, untried; this exercises them."""
    pt = batch["pairwise_t"]
    prior = batch["prior_encoding"]
    lead, l = pt.shape[:-3], pt.shape[-3]
    for idx in np.ndindex(*lead):
        for slot in range(1, l):
            yaw = np.deg2rad(rng.uniform(-PERTURB_MAX_DEG, PERTURB_MAX_DEG))
            c, s = np.cos(yaw), np.sin(yaw)
            m = np.eye(4, dtype=np.float32)
            m[:2, :2] = [[c, -s], [s, c]]
            m[:2, 3] = rng.uniform(-PERTURB_MAX_SHIFT, PERTURB_MAX_SHIFT, 2)
            pt[idx + (slot,)] = m
            prior[idx + (slot, 1)] = rng.integers(0, PERTURB_MAX_DELAY + 1)
    if "pairwise_t_full" in batch:
        shape = lead + (l, l, 4, 4)
        batch["pairwise_t_full"][...] = np.linalg.solve(
            np.broadcast_to(pt[..., :, None, :, :], shape),
            np.broadcast_to(pt[..., None, :, :, :], shape))
    return batch


def batch_to_torch(batch: dict, device="cuda") -> dict:
    """numpy batch arrays -> tensors on ``device`` (bool stays bool); nested
    dicts (the ``labels``) are moved leaf by leaf."""
    dev = resolve_device(device)

    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        return torch.from_numpy(np.ascontiguousarray(v)).to(dev)

    return move(batch)
