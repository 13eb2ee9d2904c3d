"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numpy inputs and the same flax variables: the
variables' shapes come from ``jax.eval_shape`` of the flax ``init`` and their
values from a seeded numpy generator, so batch-norm statistics and scales
(every third one negative) are far from their identity defaults.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "hypes_yaml/test/tiny_where2comm.yaml")
FLAGSHIP = os.path.join(REPO, "hypes_yaml/airv2x/lidar/det/where2comm.yaml")
SEG = os.path.join(REPO, "hypes_yaml/airv2x/lidar/seg/where2comm.yaml")
CAMERA = os.path.join(REPO, "hypes_yaml/airv2x/camera/det/where2comm.yaml")

jax.config.update("jax_default_matmul_precision", "highest")


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
