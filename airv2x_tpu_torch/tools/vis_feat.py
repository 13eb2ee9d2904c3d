"""Feature-map visualisation (counterpart of airv2x_tpu/tools/vis_feat.py).

    python -m airv2x_tpu_torch.tools.vis_feat --hypes_yaml cfg.yaml
        --output_dir <dir> [--filter backbone] [--max_maps 32] [--seed 0]
        [--device cuda|cpu]

Runs one forward pass of the config's model (seeded random weights, cast
to bf16 where the config computes in bf16) on a
``make_scene`` scene and writes a channel-mean heatmap PNG of every 4-D
activation a module returns, in the order the modules run, named by the
module's path (``backbone.deblocks.0`` -> ``backbone_deblocks_0.png``;
``--filter`` keeps the paths that contain it). The JAX tool captures flax's
intermediates instead, named by the flax scope with ``__call__`` as
``out`` (``heads/cls_head/__call__/0`` -> ``heads_cls_head_out_0.png``):
the port's module paths are the flax scopes with ``.`` for ``/``, so the
same map is ``heads.cls_head`` here (``heads_cls_head.png``). Flax's maps
are channels-last and the port's channels-first; each heatmap takes the
mean of |x| over the channels either way.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import make_scene
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.models.registry import compute_dtype
from airv2x_tpu_torch.tools.inference import model_batch
from airv2x_tpu_torch.utils.device import resolve_device
from airv2x_tpu_torch.utils.weights import cast_weights_, init_flax_like_


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BEV feature-map visualizer")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--filter", default="",
                   help="only dump features whose path contains this")
    p.add_argument("--max_maps", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


# matplotlib's viridis colour map, its 256 entries x 255 as uint8 RGB: the
# card's machine has no matplotlib, and the JAX tool maps through it
_VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"), np.uint8).reshape(256, 3)


def heatmap(arr: np.ndarray) -> np.ndarray:
    """(N, C, H, W) map -> (H, W, 3) uint8 viridis image of the first
    sample's mean |x| over the channels, scaled to its own range (the
    colour lookup of matplotlib's ``cm.viridis``, as the JAX tool's)."""
    a = np.abs(np.asarray(arr, np.float32)).mean(axis=1)[0]
    lo, hi = float(a.min()), float(a.max())
    x = (a - lo) / (hi - lo + 1e-9) * 256
    x[x == 256] = 255
    with np.errstate(invalid="ignore"):
        idx = np.clip(x, 0, 255).astype(int)
    return _VIRIDIS[idx]


def capture_maps(model: torch.nn.Module, batch: dict, name_filter: str = "") -> list:
    """[(module path, (N, C, H, W) numpy map)] of every 4-D tensor a module
    of ``model`` returned in one forward of ``batch``, in the order they
    ran (a module run twice gives its path with ``_1``, ``_2``, ...)."""
    maps, seen, hooks = [], {}, []

    def hook(name):
        def fn(_, __, out):
            if isinstance(out, torch.Tensor) and out.dim() == 4 and name_filter in name:
                k = seen.get(name, 0)
                seen[name] = k + 1
                maps.append((name if k == 0 else f"{name}_{k}",
                             out.detach().float().cpu().numpy()))
        return fn

    for name, mod in model.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(hook(name)))
    try:
        with torch.inference_mode():
            model(batch)
    finally:
        for h in hooks:
            h.remove()
    return maps


def main(argv=None) -> list:
    """Render; returns the written paths."""
    from PIL import Image

    opt = parse_args(argv)
    dev = resolve_device(opt.device)
    hypes = load_yaml(opt.hypes_yaml)
    model = init_flax_like_(build_model(hypes, device=dev), opt.seed).eval()
    if compute_dtype(hypes) == torch.bfloat16:
        cast_weights_(model, torch.bfloat16)
    rng = np.random.default_rng(opt.seed)
    scene, _ = make_scene(
        rng, model.layout, num_objects=8,
        points_per_agent=int(hypes["preprocess"].get("max_points", 8192)),
        lidar_range=hypes["preprocess"]["cav_lidar_range"])

    os.makedirs(opt.output_dir, exist_ok=True)
    written = []
    for name, v in capture_maps(model, model_batch(scene, dev), opt.filter)[:opt.max_maps]:
        fname = name.replace(".", "_") + ".png"
        Image.fromarray(heatmap(v)).save(os.path.join(opt.output_dir, fname))
        print(f"[vis_feat] {fname}  shape={v.shape}")
        written.append(os.path.join(opt.output_dir, fname))
    print(f"[vis_feat] wrote {len(written)} maps to {opt.output_dir}")
    return written


if __name__ == "__main__":
    main()
