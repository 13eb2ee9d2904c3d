"""Early fusion in the PyTorch port against the JAX package on the CPU, f32:
``airv2x_early`` (multiclass heads over the tiny config's four slots) and
the DiscoNet teacher (``chip_smoke.py:tiny_early_hypes``), forward in both
conv modes with an absent slot, then one ``make_train_step`` update each
(the teacher's on the flat family's binary tiny config,
tests/test_torch_point_pillar_family.py) against JAX's float64 step, as the
flat family's steps are held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models import build_model as jax_build_model
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.test_torch_point_pillar_family import batch as flat_batch  # noqa: F401
from tests.test_torch_point_pillar_family import tiny_hypes as flat_tiny_hypes
from tests.torch_port_helpers import (
    CHIP_SMOKE, TINY, assert_close, one_torch_thread, random_variables)
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    labelled_batch, port_step, twin, variables_for)

TOL = 1e-4  # whole-model outputs, x (1 + scale)
NAMES = ("airv2x_early", "point_pillar_disconet_teacher")


@pytest.fixture(scope="module")
def batch():
    return labelled_batch()


def _scene(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(batch, name, mode, monkeypatch):
    """The merged cloud of every present slot (the second sample's drone
    absent: its points must not enter) through the spine; the teacher's
    ``teacher_feature`` / ``teacher_psm`` / ``teacher_rm`` and aliases."""
    monkeypatch.setenv("AIRV2X_CONV_KERNEL", mode)
    jh = CHIP_SMOKE.tiny_early_hypes(jax_load_yaml(TINY), name)
    jmodel = jax_build_model(jh)
    jb = jax.tree.map(jnp.asarray, _scene(batch))
    var = random_variables(jmodel, jb, seed=5, train=False)
    want = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jmodel.apply(v, b, train=False))(var, jb))
    model = build_model(CHIP_SMOKE.tiny_early_hypes(load_yaml(TINY), name),
                        device="cpu")
    load_flax_variables(model, var)
    with torch.no_grad():
        got = model(batch_to_torch(_scene(batch), "cpu"))
    assert set(got) == set(want)
    for k in want:
        if k == "comm_rate":
            assert float(got[k]) == float(want[k]) == 0.0
            continue
        assert got[k].shape == want[k].shape and want[k].shape[:3] == (2, 48, 48)
        assert_close(got[k].numpy(), want[k], TOL * (1 + np.abs(want[k]).max()),
                     0, k)
    if name == "point_pillar_disconet_teacher":
        np.testing.assert_array_equal(got["psm"].numpy(), got["teacher_psm"].numpy())
        assert want["teacher_feature"].shape[-1] == 64


def test_absent_agent_points_do_not_enter(batch):
    """Moving the absent drone's points changes nothing."""
    h = CHIP_SMOKE.tiny_early_hypes(load_yaml(TINY), "airv2x_early")
    model = build_model(h, device="cpu")
    moved = dict(_scene(batch), points=batch["points"].copy())
    moved["points"][1, 3, :, :2] *= 0.5
    with torch.no_grad():
        a = model(batch_to_torch(_scene(batch), "cpu"))
        b = model(batch_to_torch(moved, "cpu"))
    assert torch.equal(a["psm"], b["psm"])


@pytest.fixture(scope="module", params=NAMES)
def step_run(request, batch, flat_batch):  # noqa: F811
    """One update of the port and JAX's float64 step from the same
    variables: airv2x_early on the tiny config's labelled batch, the teacher
    on the flat family's."""
    name = request.param
    if name == "airv2x_early":
        jh = CHIP_SMOKE.tiny_early_hypes(jax_load_yaml(TINY), name)
        th = CHIP_SMOKE.tiny_early_hypes(load_yaml(TINY), name)
        b = batch
    else:
        jh = th = flat_tiny_hypes("point_pillar")
        jh["model"]["core_method"] = th["model"]["core_method"] = name
        b = flat_batch
    var = variables_for(jh, b)
    params, stats, jparts, grads = jax_step(jh, b, var, dtype=jnp.float64)
    model, parts = port_step(th, b, var)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(th, grads, stats), after=twin(th, params, stats))


def test_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"])


def test_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(step_run["model"], step_run["after"],
                                  step_run["grads"], min_clear=100) > 0
