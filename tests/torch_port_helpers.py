"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs and the same flax variables: the
variables' shapes come from ``jax.eval_shape`` of the flax ``init`` and their
values from a seeded numpy generator, so batch-norm statistics and scales
(every third one negative) are far from their identity defaults.
"""

from __future__ import annotations

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
FLAGSHIP = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/where2comm.yaml")
SEG = os.path.join(REPO, "hypes_yaml/airv2x/lidar/seg/where2comm.yaml")
CAMERA = os.path.join(REPO, "hypes_yaml/airv2x/camera/det/where2comm.yaml")
V2XVIT = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/v2xvit.yaml")
V2XVIT_SEG = os.path.join(REPO, "hypes_yaml/airv2x/lidar/seg/v2xvit.yaml")
SCOPE = os.path.join(REPO, "hypes_yaml/opv2v/opv2v_scope.yaml")



def load_chip_smoke():
    """chip_smoke.py as a module (its top level imports only numpy and
    torch): it holds the one copy of the tiny V2X-ViT transformer and of the
    tiny SCOPE config and its scene builder, which its phases 4d / 4e, the
    card tests and the CPU tests all run."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the tiny V2X-ViT transformer: tests/test_model_zoo.py's airv2x_v2xvit
# block with three windows and split attention (or, ``windows=2``, the zoo's
# own two windows and naive mean), at the tiny backbone's feature stride 2
CHIP_SMOKE = load_chip_smoke()
TINY_V2XVIT_ENCODER = CHIP_SMOKE.TINY_V2XVIT_ENCODER
TINY_PWINDOW = {
    3: {k: TINY_V2XVIT_ENCODER["pwindow_att_config"][k]
        for k in ("heads", "dim_head", "window_size", "fusion_method")},
    2: {"heads": [4, 2], "dim_head": [16, 32], "window_size": [2, 4],
        "fusion_method": "naive"},
}

jax.config.update("jax_default_matmul_precision", "highest")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread in every test of a module that imports this
    fixture (it is autouse). Under the parallel test run every worker's
    thread pool competes for the cores, and a train step of many small ops
    then waits on descheduled pool threads far longer than one thread
    takes; module-wide, every run a module compares for equality uses the
    same thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def random_variables(module, *args, seed: int = 0, **kwargs):
    """Seeded numpy values for every variable of a flax module's ``init``."""
    shapes = jax.eval_shape(
        lambda *a: module.init(
            {"params": jax.random.PRNGKey(0), "comm": jax.random.PRNGKey(1)},
            *a, **kwargs),
        *args,
    )
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(2 / fan_in), s.shape).astype(np.float32)
        if name == "scale":  # every third channel negative
            sign = np.where(np.arange(s.shape[-1]) % 3 == 1, -1.0, 1.0)
            return (rng.uniform(0.5, 1.5, s.shape) * sign).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, s.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree.map(np.asarray, tree)


def nhwc_to_nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nchw_to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def assert_close(got, want, atol, rtol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    lim = atol + rtol * np.abs(want)
    assert np.all(err <= lim), (
        f"{what}: max abs err {err.max():.3e} (scale {np.abs(want).max():.3e})")


def jnp_tree(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tiny_seg(hypes: dict) -> dict:
    """The tiny config (TINY, loaded by either package) turned into the
    BEV-segmentation task: ``task: seg`` at the top and in the model args."""
    hypes["task"] = "seg"
    hypes["model"]["args"]["task"] = "seg"
    return hypes


def tiny_v2xvit_encoder(windows: int = 3) -> dict:
    """The tiny ``transformer.encoder`` block (dim 64, heads 4, dim_head
    16, depth 1) with ``windows`` windows (TINY_PWINDOW)."""
    enc = copy.deepcopy(TINY_V2XVIT_ENCODER)
    enc["pwindow_att_config"].update(copy.deepcopy(TINY_PWINDOW[windows]))
    return enc


def tiny_v2xvit(hypes: dict, windows: int = 3) -> dict:
    """The tiny config (TINY, loaded by either package) as the V2X-ViT
    model, patched as tests/test_model_zoo.py patches it."""
    hypes["model"]["core_method"] = "airv2x_v2xvit"
    hypes["model"]["args"]["transformer"] = {
        "encoder": tiny_v2xvit_encoder(windows)}
    return hypes
