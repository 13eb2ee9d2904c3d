"""BM2CP training in the PyTorch port against the JAX package on the CPU:
one ``make_train_step`` update of the tiny ``airv2x_bm2cp`` det model and
of the flat ``point_pillar_bm2cp`` (the seg model's in
tests/test_torch_bm2cp_train_seg.py, which runs in parallel) (``chip_smoke.py:
tiny_bm2cp_hypes``) against JAX's f32 step, from one bridged
initialisation, on tests/torch_train_helpers.py's labelled batch (perturbed
poses, the second sample's drone absent) with two cameras per slot.

The tolerances are the camera steps' (tests/test_torch_train_camera.py):
the EfficientNet trunks' train-mode BNs take their statistics over 24 - 48
values per channel at the last stage. With one camera of 32 x 48 per slot
they took two, and the port's own f32 loss moved by 3% between one and two
CPU threads: the two cameras of 64 x 96 keep the step well conditioned
(the port's f32 loss within 2e-7 of its float64 one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import bm2cp_airv2x_batch as jax_bm2cp_batch
from airv2x_tpu_torch.config import load_yaml
from tests.test_torch_train_camera import (
    CAMERA_GRAD_TOL, CAMERA_LOSS_TOL, CAMERA_STAT_TOL)
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, labelled_batch,
    run_both, variables_for)

CASES = {"airv2x_bm2cp-det": ("airv2x_bm2cp", "det"),
         "point_pillar_bm2cp": ("point_pillar_bm2cp", "det")}


def bm2cp_batch(hypes, name):
    """The labelled batch with two BM2CP cameras per slot (the JAX
    package's ``bm2cp_airv2x_batch``, seeds 1 and 2); the flat model reads
    the vehicle block over its four slots."""
    batch = labelled_batch()
    cams = [jax_bm2cp_batch(CHIP_SMOKE.tiny_bm2cp_hypes(hypes), np.random.default_rng(s),
                            batch_size=2) for s in (1, 2)]
    for key in cams[0]:
        if key.startswith("cam_"):
            batch[key] = {k: np.concatenate([c[key][k] for c in cams], axis=2)
                          for k in cams[0][key]}
    if name == "point_pillar_bm2cp":
        veh = batch.pop("cam_vehicle")
        for t in ("rsu", "drone"):
            batch.pop(f"cam_{t}")
        batch["cam_vehicle"] = {k: np.concatenate([v[:, :2], v[:, :2]], axis=1)
                                for k, v in veh.items()}
    return batch


def bm2cp_step_run(name, task):
    """run_both of the tiny model ``name`` for ``task``."""
    jh = CHIP_SMOKE.tiny_bm2cp_hypes(jax_load_yaml(TINY), name, task)
    th = CHIP_SMOKE.tiny_bm2cp_hypes(load_yaml(TINY), name, task)
    batch = bm2cp_batch(jh, name)
    return run_both(jh, th, batch, variables_for(jh, batch))


@pytest.fixture(scope="module", params=sorted(CASES))
def step_run(request):
    return bm2cp_step_run(*CASES[request.param])


def test_bm2cp_train_step_loss_parts_match_jax(step_run):
    print("loss parts, largest relative error",
          check_loss_parts(step_run["parts"], step_run["jparts"], CAMERA_LOSS_TOL))


def test_bm2cp_train_step_gradients_match_jax(step_run):
    print("gradients, largest share of the bound",
          check_gradients(step_run["model"], step_run["grads"], CAMERA_GRAD_TOL))


def test_bm2cp_train_step_params_and_bn_stats_match_jax(step_run):
    n = check_params_and_stats(step_run["model"], step_run["after"],
                               step_run["grads"], grad_tol=CAMERA_GRAD_TOL,
                               stat_tol=CAMERA_STAT_TOL, min_clear=100)
    assert n > 100  # the camera trunks' running statistics among them
