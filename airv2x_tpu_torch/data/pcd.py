"""PCD point clouds (counterpart of airv2x_tpu/data/pcd.py ``read_pcd`` /
``write_pcd`` and of the post-processing of airv2x_tpu/data/native.py
``load_pcd_into``), numpy only.

Reads the subset the AirV2X dataset uses: x / y / z / intensity fields in
ascii or binary little-endian PCD files. NaN rows are dropped; intensity
defaults to 1.0 when absent. The V2X-R simulated-weather clouds pack the
intensity and a per-point weather label into an ``rgb`` column (red the
intensity, green the label, each byte over 255): ``read_pcd`` takes the
intensity from it and, with ``return_label``, the label, which
``load_pcd_label_into`` turns into the clean-point mask of MDD's training
samples (the JAX package's ``native.load_pcd_label_into``, pure Python
there too). The port has one reader, this one: the JAX package's native
``libfastpcd`` parses and transforms in C float32, this path in numpy.
"""

from __future__ import annotations

import numpy as np

from airv2x_tpu_torch.utils.transforms import transform_points

_DTYPES = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 4): "<i4", ("U", 4): "<u4",
           ("I", 1): "<i1", ("U", 1): "<u1", ("I", 2): "<i2", ("U", 2): "<u2"}


def read_pcd(path: str, return_label: bool = False):
    """Read a .pcd file -> (N, 4) float32 [x, y, z, intensity], and with
    ``return_label`` the (N,) float32 weather label (0 where the file has
    no ``rgb`` column: every point clean)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PCD header has no DATA line")
            line = line.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in
                  header.get("COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        mode = header["DATA"].lower()
        np_dtype = np.dtype([
            (name, _DTYPES[(t, s)], (cnt,)) if cnt > 1 else (name, _DTYPES[(t, s)])
            for name, s, t, cnt in zip(fields, sizes, types, counts)
        ])
        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, -1)
            cols, i = {}, 0
            for name, cnt in zip(fields, counts):
                cols[name] = raw[:, i] if cnt == 1 else raw[:, i:i + cnt]
                i += cnt
        elif mode == "binary":
            data = np.frombuffer(f.read(n * np_dtype.itemsize), dtype=np_dtype,
                                 count=n)
            cols = {name: np.asarray(data[name], np.float64) for name in fields}
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    x, y, z = cols["x"], cols["y"], cols["z"]
    label = np.zeros(len(x), np.float32)
    if "rgb" in cols:  # packed bytes: a uint32, or a float32's bits
        if types[fields.index("rgb")] == "U":
            u = np.asarray(cols["rgb"], np.float64).astype(np.uint32)
        else:
            u = np.ascontiguousarray(np.asarray(
                cols["rgb"], np.float64).astype(np.float32)).view(np.uint32)
        inten = ((u >> 16) & 0xFF).astype(np.float32) / 255.0
        label = ((u >> 8) & 0xFF).astype(np.float32) / 255.0
    else:
        inten = cols.get("intensity", np.ones_like(x))
    pts = np.stack([x, y, z, inten], axis=-1).astype(np.float32)
    keep = ~np.isnan(pts).any(axis=1)
    if return_label:
        return pts[keep], label[keep]
    return pts[keep]


def write_pcd(path: str, points: np.ndarray,
              label: np.ndarray | None = None) -> None:
    """Write (N, 4) [x, y, z, intensity] to a binary PCD file; with
    ``label`` (N,) in [0, 1] the intensity and the label go into a packed
    float32 ``rgb`` column instead (red, green), as V2X-R stores them."""
    n = len(points)
    pts = np.asarray(points, np.float32)
    fields = "x y z intensity"
    if label is not None:
        r = np.clip(np.round(pts[:, 3] * 255.0), 0, 255).astype(np.uint32)
        g = np.clip(np.round(np.asarray(label) * 255.0), 0, 255).astype(np.uint32)
        rgb = ((r << 16) | (g << 8)).view(np.float32)
        pts = np.concatenate([pts[:, :3], rgb[:, None]], axis=1)
        fields = "x y z rgb"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        "SIZE 4 4 4 4\n"
        "TYPE F F F F\n"
        "COUNT 1 1 1 1\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        "DATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.astype("<f4").tobytes())


def load_pcd_into(path: str, out: np.ndarray, *, transform=None,
                  lidar_range=None, ego_mask: float = 0.0) -> int:
    """Fill ``out`` (N, 4) float32 with the file's points after the NaN
    drop, the ego mask (|x| and |y| both under ``ego_mask``), the rigid
    ``transform`` (4 x 4 float32) and the open-interval range crop; returns
    the count written (at most N)."""
    return load_pcd_label_into(path, out, None, transform=transform,
                               lidar_range=lidar_range, ego_mask=ego_mask)


def load_pcd_label_into(path: str, out: np.ndarray, clean, *, transform=None,
                        lidar_range=None, ego_mask: float = 0.0) -> int:
    """``load_pcd_into``, and where ``clean`` (N,) bool is given, True for
    each written point whose weather label is 0 (a real point, not weather
    noise)."""
    if out.dtype != np.float32 or out.ndim != 2 or out.shape[1] != 4:
        raise ValueError(f"out must be (N, 4) float32, got {out.dtype} "
                         f"{out.shape}")
    pts, label = read_pcd(path, return_label=True)
    if ego_mask > 0:
        keep = ~((np.abs(pts[:, 0]) < ego_mask) & (np.abs(pts[:, 1]) < ego_mask))
        pts, label = pts[keep], label[keep]
    if transform is not None:
        pts = transform_points(pts, transform).astype(np.float32)
    if lidar_range is not None:
        lr = lidar_range
        keep = ((pts[:, 0] > lr[0]) & (pts[:, 0] < lr[3])
                & (pts[:, 1] > lr[1]) & (pts[:, 1] < lr[4])
                & (pts[:, 2] > lr[2]) & (pts[:, 2] < lr[5]))
        pts, label = pts[keep], label[keep]
    n = min(len(pts), out.shape[0])
    out[:n] = pts[:n]
    if clean is not None:
        clean[:n] = label[:n] == 0
    return n
