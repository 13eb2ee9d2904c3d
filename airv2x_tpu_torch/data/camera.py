"""Host-side camera inputs and the seg task's BEV label readers
(counterpart of airv2x_tpu/data/camera.py, numpy and PIL only).

  * per-agent-type camera keys: the metadata keys in the reference's
    order, each file stem the key without ``_camera``;
  * ue4 -> LSS extrinsic conversion and its inverse;
  * the CARLA 24-bit depth decode (metres) and its encoder;
  * the LSS image augmentation: resize / crop / flip / rotate with the
    post_rot / post_tran homography, drawn in the JAX package's order;
  * imagenet normalization;
  * ``load_agent_cam_inputs`` (one agent's cameras) and ``stack_cam_slots``
    (the fixed per-slot blocks of one agent type);
  * BM2CP's LiDAR-depth projection: ``depth_discretization_np``,
    ``project_lidar_depth_map`` (one camera) and ``load_agent_depth_maps``
    (one agent's cameras), min depth-bin levels, -1 where no return lands;
  * ``load_opv2v_cam_inputs``: an OPV2V vehicle's four cameras;
  * the 7 dynamic and 3 static BEV layer masks as class-id maps.

Outputs are channel-last numpy arrays, the contract of
``data.synthetic.add_camera_inputs``: imgs (Ncam, H, W, 3[+1]) float32,
intrinsics (Ncam, 3, 3), rots / trans of the cam -> lidar matrix in LSS
axes, post_rots / post_trans (3 x 3 / 3), and for BM2CP depth_maps
(Ncam, fH, fW).
"""

from __future__ import annotations

import os

import numpy as np

# camera order per agent type: the metadata keys in the reference's order
CAM_KEYS = {
    "vehicle": (
        "front_camera",
        "front_left_camera",
        "front_right_camera",
        "rear_camera",
        "rear_left_camera",
        "rear_right_camera",
    ),
    "rsu": ("back_camera", "front_camera", "left_camera", "right_camera"),
    "drone": ("bev_camera",),
}

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

DYNAMIC_SEG_FILES = tuple(f"map_dynamic_bev_layer_{i}.png" for i in range(7))
STATIC_SEG_FILES = (
    "map_static_background.png",
    "map_static_lane.png",
    "map_static_road.png",
)

_UE4_TO_LSS_R = np.array(
    [[0, 0, 1], [1, 0, 0], [0, -1, 0]], dtype=np.float32
)  # x_new = y_old, y_new = -z_old, z_new = x_old

# the aug keys ``sample_augmentation`` reads besides final_dim
AUG_KEYS = ("H", "W", "resize_lim", "bot_pct_lim", "rot_lim")


def ue4_to_lss(camera_to_lidar_matrix: np.ndarray) -> np.ndarray:
    """UE4-convention extrinsic -> cam -> lidar matrix in LSS camera axes:
    the inverse, right-multiplied by the axis swap, in float64, then f32."""
    m = np.linalg.inv(np.asarray(camera_to_lidar_matrix, np.float64))
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = _UE4_TO_LSS_R
    return (m @ t).astype(np.float32)


def lss_to_ue4(cam_to_lidar_lss: np.ndarray) -> np.ndarray:
    """Inverse of :func:`ue4_to_lss` (scenario writers use it)."""
    t = np.eye(4, dtype=np.float64)
    t[:3, :3] = _UE4_TO_LSS_R
    return np.linalg.inv(
        np.asarray(cam_to_lidar_lss, np.float64) @ np.linalg.inv(t)
    ).astype(np.float32)


def decode_depth_carla(path: str) -> np.ndarray:
    """CARLA RGB-encoded depth PNG -> metres (H, W) float32."""
    from PIL import Image

    with Image.open(path) as img:
        rgb = np.asarray(img.convert("RGB"), np.uint32)
    raw = rgb[..., 0] + rgb[..., 1] * 256 + rgb[..., 2] * 256 * 256
    return (raw.astype(np.float64) / (256**3 - 1) * 1000.0).astype(np.float32)


def encode_depth_carla(depth_m: np.ndarray) -> np.ndarray:
    """Metres -> CARLA RGB uint8 encoding (scenario writers use it)."""
    raw = np.clip(
        np.round(depth_m.astype(np.float64) / 1000.0 * (256**3 - 1)), 0, 256**3 - 1
    ).astype(np.uint32)
    return np.stack(
        [raw % 256, (raw // 256) % 256, (raw // 65536) % 256], axis=-1
    ).astype(np.uint8)


def sample_augmentation(conf: dict, train: bool, rng=None):
    """The LSS augmentation of one camera -> (resize, resize_dims, crop,
    flip, rotate_deg). Training draws resize, bottom crop, horizontal crop,
    flip and rotation from ``rng`` in that order; eval takes the resize that
    covers ``final_dim``, the mean bottom crop and the centred horizontal
    crop. The crop's top may lie above the image (a negative ``crop_h``).
    Raises KeyError naming the missing keys when ``conf`` lacks one of
    AUG_KEYS, as the JAX package raises on the first."""
    missing = [k for k in AUG_KEYS if k not in conf]
    if missing:
        raise KeyError(f"data_aug_conf lacks {missing}: the camera "
                       "augmentation needs H, W, resize_lim, bot_pct_lim and "
                       "rot_lim besides final_dim")
    h, w = conf["H"], conf["W"]
    fh, fw = conf["final_dim"]
    if train:
        rng = rng or np.random.default_rng()
        resize = rng.uniform(*conf["resize_lim"])
        resize_dims = (int(w * resize), int(h * resize))
        new_w, new_h = resize_dims
        crop_h = int((1 - rng.uniform(*conf["bot_pct_lim"])) * new_h) - fh
        crop_w = int(rng.uniform(0, max(0, new_w - fw)))
        flip = bool(conf.get("rand_flip")) and bool(rng.integers(0, 2))
        rotate = float(rng.uniform(*conf["rot_lim"]))
    else:
        resize = max(fh / h, fw / w)
        resize_dims = (int(w * resize), int(h * resize))
        new_w, new_h = resize_dims
        crop_h = int((1 - np.mean(conf["bot_pct_lim"])) * new_h) - fh
        crop_w = int(max(0, new_w - fw) / 2)
        flip, rotate = False, 0.0
    crop = (crop_w, crop_h, crop_w + fw, crop_h + fh)
    return resize, resize_dims, crop, flip, rotate


def _rot2(deg: float) -> np.ndarray:
    h = np.radians(deg)
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float32
    )


def img_transform(pil_imgs, resize, resize_dims, crop, flip, rotate):
    """Apply one sampled augmentation to PIL images (PIL's default resize
    filter, ``crop``, which fills a box outside the image with zeros,
    ``FLIP_LEFT_RIGHT``, ``rotate``) -> (images, post_rot2, post_tran2), the
    homography from original to augmented pixel coordinates."""
    from PIL import Image

    out = []
    for img in pil_imgs:
        img = img.resize(resize_dims)
        img = img.crop(crop)
        if flip:
            img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
        img = img.rotate(rotate)
        out.append(img)

    post_rot = np.eye(2, dtype=np.float32) * resize
    post_tran = -np.asarray(crop[:2], np.float32)
    if flip:
        a = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = a @ post_rot
        post_tran = a @ post_tran + b
    a = _rot2(rotate)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2
    b = a @ (-b) + b
    return out, a @ post_rot, a @ post_tran + b


def normalize_img(pil_img) -> np.ndarray:
    """PIL RGB -> imagenet-normalized (H, W, 3) float32."""
    arr = np.asarray(pil_img.convert("RGB"), np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_agent_cam_inputs(agent_dir: str, meta: dict, agent_type: str,
                          data_aug_conf: dict, train: bool, rng=None,
                          with_depth: bool = True):
    """Load and augment the cameras of one agent -> a dict of numpy arrays,
    or None when none of its cameras is on disk (a missing camera is
    skipped): imgs (N, fH, fW, 3[+1]), intrinsics (N, 3, 3), rots (N, 3, 3)
    / trans (N, 3) of the LSS-axes cam -> lidar matrix, post_rots (N, 3, 3),
    post_trans (N, 3). With ``with_depth`` the images always have 4
    channels: the depth in metres (through a 16-bit PIL image, so that it
    is cropped and resized with the rgb) or zeros where the depth PNG is
    absent. One augmentation is drawn per camera, in camera order."""
    from PIL import Image

    imgs, intrins, rots, trans, post_rots, post_trans = [], [], [], [], [], []
    for key in CAM_KEYS[agent_type]:
        cam_path = os.path.join(agent_dir, key + ".png")
        if not os.path.isfile(cam_path):
            continue
        depth_path = os.path.join(agent_dir, key.replace("camera", "depth") + ".png")
        entry = meta[key]
        intrin = np.asarray(entry["intrinsic"], np.float32).reshape(3, 3)
        cam_to_lidar = ue4_to_lss(
            np.asarray(entry["extrinsic"], np.float32).reshape(4, 4))

        with Image.open(cam_path) as img:
            img.load()
            pil_list = [img]
        has_depth = with_depth and os.path.isfile(depth_path)
        if has_depth:
            depth_m = decode_depth_carla(depth_path)
            scaled = np.clip(depth_m * 65535.0 / 1000.0, 0, 65535).astype(
                np.uint16)
            pil_list.append(Image.fromarray(scaled))  # uint16 -> mode I;16

        aug = sample_augmentation(data_aug_conf, train, rng)
        pil_list, post_rot2, post_tran2 = img_transform(pil_list, *aug)

        rgb = normalize_img(pil_list[0])
        if has_depth:
            d = np.asarray(pil_list[1], np.float32) * 1000.0 / 65535.0
            img = np.concatenate([rgb, d[..., None]], axis=-1)
        elif with_depth:
            img = np.concatenate(
                [rgb, np.zeros(rgb.shape[:2] + (1,), np.float32)], axis=-1)
        else:
            img = rgb
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, np.float32)
        post_rot[:2, :2] = post_rot2
        post_tran[:2] = post_tran2

        imgs.append(img)
        intrins.append(intrin)
        rots.append(cam_to_lidar[:3, :3])
        trans.append(cam_to_lidar[:3, 3])
        post_rots.append(post_rot)
        post_trans.append(post_tran)

    if not imgs:
        return None
    return {
        "imgs": np.stack(imgs).astype(np.float32),
        "intrinsics": np.stack(intrins),
        "rots": np.stack(rots),
        "trans": np.stack(trans),
        "post_rots": np.stack(post_rots),
        "post_trans": np.stack(post_trans),
    }


def depth_discretization_np(d_min, d_max, num_bins, mode) -> np.ndarray:
    """camera_utils.depth_discretization in float64: the bin starts, uniform
    (UD) or with linearly increasing widths (LID)."""
    if mode == "UD":
        return np.linspace(d_min, d_max, num_bins, dtype=np.float64)
    idx = np.arange(num_bins, dtype=np.float64)
    delta = 2 * (d_max - d_min) / (num_bins * (1 + num_bins))
    return d_min + delta * idx * (idx + 1) / 2


def project_lidar_depth_map(lidar_xyz: np.ndarray, intrinsic: np.ndarray,
                            extrinsic_ue4: np.ndarray, img_hw: tuple,
                            depth_discre: np.ndarray, final_hw: tuple) -> np.ndarray:
    """A LiDAR cloud -> one camera's per-pixel minimum depth level
    (the BM2CP dataset's generate_depth_map with
    airv2x_utils.project_lidar_to_cam_single): the points into the camera
    by the UE4 extrinsic (LiDAR -> camera), to the OpenCV axes ([y, -z,
    x]), the pin-hole projection rounded half up to pixels, the least
    discretized level per pixel, then min-pooled to ``final_hw``. Pixels
    without a return are -1. float64 on the host, as the JAX package."""
    img_h, img_w = img_hw
    f_h, f_w = final_hw
    dm_full = np.full((img_h, img_w), np.inf, np.float32)
    if lidar_xyz.shape[0]:
        lidar2cam = np.asarray(extrinsic_ue4, np.float64)
        pts = lidar_xyz[:, :3].astype(np.float64) @ lidar2cam[:3, :3].T
        pts = pts + lidar2cam[:3, 3]
        cam_pts = np.stack([pts[:, 1], -pts[:, 2], pts[:, 0]], axis=1)
        depth = cam_pts[:, 2]
        uvw = cam_pts @ np.asarray(intrinsic, np.float64).T
        with np.errstate(divide="ignore", invalid="ignore"):
            uv = uvw[:, :2] / depth[:, None]
        uv_int = np.floor(uv + 0.5).astype(np.int64)
        col, row = uv_int[:, 0], uv_int[:, 1]
        valid = ((depth >= depth_discre[0]) & (row >= 0) & (row < img_h)
                 & (col >= 0) & (col < img_w))
        lvl = np.searchsorted(depth_discre, depth[valid], side="left")
        lvl = np.maximum(lvl, 1) - 1
        np.minimum.at(dm_full, (row[valid], col[valid]), lvl.astype(np.float32))
    sh, sw = img_h // f_h, img_w // f_w
    if sh >= 1 and sw >= 1 and img_h % f_h == 0 and img_w % f_w == 0:
        dm = dm_full.reshape(f_h, sh, f_w, sw).min(axis=(1, 3))
    else:  # a non-integer scale: the nearest sample
        ys = np.clip((np.arange(f_h) * img_h / f_h).astype(int), 0, img_h - 1)
        xs = np.clip((np.arange(f_w) * img_w / f_w).astype(int), 0, img_w - 1)
        dm = dm_full[np.ix_(ys, xs)]
    dm[~np.isfinite(dm)] = -1.0
    return dm.astype(np.float32)


def load_agent_depth_maps(agent_dir: str, meta: dict, agent_type: str,
                          lidar_xyz: np.ndarray, grid_conf: dict,
                          final_hw: tuple,
                          cav_to_points: np.ndarray | None = None):
    """One agent's LiDAR projected into each of its cameras on disk (the
    BM2CP sample assembly, intermediate_fusion_dataset_bm2cp.py:661-679):
    (Ncam, fH, fW) minimum depth levels, -1 without a return, or None
    without cameras. ``cav_to_points`` is the agent -> points-frame
    transform where the cloud is not in the agent's frame (``proj_first``
    puts it in the ego's), so the extrinsics follow the points."""
    from PIL import Image

    dd = depth_discretization_np(*grid_conf["ddiscr"], grid_conf["mode"])
    maps = []
    for key in CAM_KEYS[agent_type]:
        cam_path = os.path.join(agent_dir, key + ".png")
        if not os.path.isfile(cam_path):
            continue
        with Image.open(cam_path) as im:
            img_w, img_h = im.size
        extr = np.asarray(meta[key]["extrinsic"], np.float64).reshape(4, 4)
        if cav_to_points is not None:
            # lidar(points frame) -> cam = (lidar(cav) -> cam) @ inv(cav -> points)
            extr = extr @ np.linalg.inv(np.asarray(cav_to_points, np.float64))
        maps.append(project_lidar_depth_map(
            lidar_xyz, np.asarray(meta[key]["intrinsic"], np.float64).reshape(3, 3),
            extr, (img_h, img_w), dd, final_hw))
    if not maps:
        return None
    return np.stack(maps)


# OPV2V cameras: four per vehicle, files ``<timestamp>_camera{i}.png``, each
# with its ``cords`` pose and ``intrinsic``; lidar -> cam = pose_a_to_b(lidar
# pose, camera pose) @ the axis swap below, and cam (LSS) -> lidar its inverse
_OPV2V_SWAP = np.array(
    [[0, 0, 1, 0], [1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64)


def load_opv2v_cam_inputs(cav_dir: str, stamp: str, meta: dict,
                          data_aug_conf: dict, train: bool, rng=None):
    """Load and augment an OPV2V vehicle's four cameras into the LSS input
    contract (imgs, intrinsics, rots, trans, post_rots, post_trans), or
    None when no camera file exists; one augmentation per camera."""
    from PIL import Image

    from airv2x_tpu_torch.utils import transforms as tf

    lidar_pose = meta["lidar_pose"]
    imgs, intrins, rots, trans, post_rots, post_trans = [], [], [], [], [], []
    for i in range(4):
        path = os.path.join(cav_dir, f"{stamp}_camera{i}.png")
        if f"camera{i}" not in meta or not os.path.isfile(path):
            continue
        entry = meta[f"camera{i}"]
        intrin = np.asarray(entry["intrinsic"], np.float32).reshape(3, 3)
        l2c = tf.pose_a_to_b(lidar_pose, entry["cords"]) @ _OPV2V_SWAP
        cam_to_lidar = np.linalg.inv(l2c).astype(np.float32)
        with Image.open(path) as img:
            img.load()
            pil = [img]
        aug = sample_augmentation(data_aug_conf, train, rng)
        pil, post_rot2, post_tran2 = img_transform(pil, *aug)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, np.float32)
        post_rot[:2, :2] = post_rot2
        post_tran[:2] = post_tran2
        imgs.append(normalize_img(pil[0]))
        intrins.append(intrin)
        rots.append(cam_to_lidar[:3, :3])
        trans.append(cam_to_lidar[:3, 3])
        post_rots.append(post_rot)
        post_trans.append(post_tran)
    if not imgs:
        return None
    return {"imgs": np.stack(imgs).astype(np.float32),
            "intrinsics": np.stack(intrins), "rots": np.stack(rots),
            "trans": np.stack(trans), "post_rots": np.stack(post_rots),
            "post_trans": np.stack(post_trans)}


def stack_cam_slots(cam_slots: dict, num_slots: int) -> dict:
    """{slot: one agent's camera dict} -> fixed (num_slots, ...) arrays,
    zero outside the populated slots, the identity in ``post_rots``,
    ``intrinsics`` and ``rots`` (which must stay invertible), -1 in
    ``depth_maps`` (no return, never level 0). Raises when two agents carry
    different camera counts."""
    first = next(iter(cam_slots.values()))
    stacked = {}
    for key, arr in first.items():
        full = np.zeros((num_slots,) + arr.shape, arr.dtype)
        if key in ("post_rots", "intrinsics", "rots"):
            full[...] = np.eye(3, dtype=arr.dtype)
        elif key == "depth_maps":
            full[...] = -1.0
        for slot, cam in cam_slots.items():
            if cam[key].shape != arr.shape:
                raise ValueError(
                    f"camera block '{key}' shape {cam[key].shape} differs "
                    f"from slot 0's {arr.shape} — agents of one type must "
                    "carry the same number of cameras")
            full[slot] = cam[key]
        stacked[key] = full
    return stacked


def _binary_label_map(agent_dir: str, filenames) -> np.ndarray | None:
    """Stack threshold (> 10) masks into a class-id map, the last layer
    winning; transposed and column-flipped as the reference's
    ``basedataset._wrap_segmentation_map``. None when a file is missing."""
    from PIL import Image

    masks = []
    for fn in filenames:
        p = os.path.join(agent_dir, fn)
        if not os.path.isfile(p):
            return None
        with Image.open(p) as img:
            arr = np.asarray(img.convert("L"))
        masks.append((arr > 10).astype(np.uint8))
    label = np.zeros_like(masks[0])
    for idx, m in enumerate(masks):
        label[m == 1] = idx
    label = label.T
    return np.ascontiguousarray(label[:, ::-1])


def load_seg_labels(agent_dir: str):
    """(dynamic (H, W) uint8 | None, static (H, W) uint8 | None)."""
    return (
        _binary_label_map(agent_dir, DYNAMIC_SEG_FILES),
        _binary_label_map(agent_dir, STATIC_SEG_FILES),
    )
