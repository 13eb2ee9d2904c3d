"""YAML experiment-config loader (trimmed copy of airv2x_tpu/config/loader.py).

Keeps ``load_yaml``, ``save_yaml``, the ``load_airv2x_params`` deriver
that the AirV2X configs name and ``load_point_pillar_params``, the OPV2V
point-pillar family's (SCOPE); the other parsers of the JAX package wait
for the workloads that use them.
"""

from __future__ import annotations

import math
import os
import re
from typing import Callable

import numpy as np
import yaml


class _Loader(yaml.SafeLoader):
    """SafeLoader with a float resolver that accepts 1e-4 style literals
    (pyyaml's default resolver misses floats without a dot)."""


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _grid_size(lidar_range, voxel_size) -> np.ndarray:
    return np.round(
        (np.array(lidar_range[3:6]) - np.array(lidar_range[0:3]))
        / np.array(voxel_size)
    ).astype(np.int64)


def load_airv2x_params(param: dict) -> dict:
    """Fill per-agent-type ``point_pillar_scatter.grid_size``, the
    postprocess ``anchor_args`` W/H/D + voxel sizes, and ``max_cav_num``."""
    max_cav = param["train_params"]["max_cav"]
    max_cav_num = sum(max_cav.get(k, 0) for k in ("vehicle", "rsu", "drone"))
    param["train_params"]["max_cav_num"] = max_cav_num
    param["model"]["args"]["max_cav_num"] = max_cav_num

    for agent in ("vehicle", "rsu", "drone"):
        cfg = param["model"]["args"].get(agent)
        if not cfg or "lidar" not in cfg:
            continue
        gs = _grid_size(cfg["lidar"]["lidar_range"], cfg["lidar"]["voxel_size"])
        cfg["lidar"]["point_pillar_scatter"]["grid_size"] = gs

    _fill_anchor_args(param)
    return param


def load_point_pillar_params(param: dict) -> dict:
    """Fill the model's ``point_pillar_scatter.grid_size`` (when the block
    is present) and the postprocess ``anchor_args`` W/H/D + voxel sizes."""
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    voxel_size = param["preprocess"]["args"]["voxel_size"]
    if "point_pillar_scatter" in param["model"]["args"]:
        param["model"]["args"]["point_pillar_scatter"]["grid_size"] = (
            _grid_size(cav_lidar_range, voxel_size))
    _fill_anchor_args(param)
    return param


def load_airv2x_bm2cp_params(param: dict) -> dict:
    """BM2CP's deriver: ``load_airv2x_params``, then the vehicle and rsu
    ``pc_params.point_pillar_scatter.grid_size`` from the shared grid (the
    reference reads an undefined ``rsu_lidar_range`` there; both types use
    ``cav_lidar_range``, as in the JAX package)."""
    param = load_airv2x_params(param)
    gs = _grid_size(param["preprocess"]["cav_lidar_range"],
                    param["preprocess"]["args"]["voxel_size"])
    for agent in ("vehicle", "rsu"):
        cfg = param["model"]["args"].get(agent)
        if cfg and "pc_params" in cfg:
            cfg["pc_params"]["point_pillar_scatter"]["grid_size"] = gs
    return param


def _fill_anchor_args(param: dict) -> None:
    cav_lidar_range = param["preprocess"]["cav_lidar_range"]
    anchor_args = param["postprocess"]["anchor_args"]
    vw, vh, vd = param["preprocess"]["args"]["voxel_size"]
    anchor_args["vw"], anchor_args["vh"], anchor_args["vd"] = vw, vh, vd
    anchor_args["W"] = math.ceil((cav_lidar_range[3] - cav_lidar_range[0]) / vw)
    anchor_args["H"] = math.ceil((cav_lidar_range[4] - cav_lidar_range[1]) / vh)
    anchor_args["D"] = math.ceil((cav_lidar_range[5] - cav_lidar_range[2]) / vd)


PARSER_REGISTRY: dict[str, Callable[[dict], dict]] = {
    "load_airv2x_params": load_airv2x_params,
    "load_point_pillar_params": load_point_pillar_params,
    "load_airv2x_bm2cp_params": load_airv2x_bm2cp_params,
}


def load_yaml(file_path: str | None, model_dir: str | None = None) -> dict:
    """Load an experiment config and apply its ``yaml_parser``; when
    ``model_dir`` holds a ``config.yaml`` snapshot (a run dir), that
    snapshot is read in place of ``file_path``."""
    if model_dir is not None:
        snapshot = os.path.join(model_dir, "config.yaml")
        if os.path.isfile(snapshot):
            file_path = snapshot
    with open(file_path, "r") as f:
        params = yaml.load(f, Loader=_Loader)

    parser_name = params.get("yaml_parser")
    if parser_name:
        parser = PARSER_REGISTRY.get(parser_name)
        if parser is None:
            raise KeyError(
                f"unknown yaml_parser '{parser_name}'; registered: "
                f"{sorted(PARSER_REGISTRY)}"
            )
        params = parser(params)
    return params


def save_yaml(data: dict, path: str) -> None:
    """Write a config (numpy arrays and scalars as plain lists and numbers)."""
    with open(path, "w") as f:
        yaml.safe_dump(_plain(data), f, default_flow_style=False)


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj
