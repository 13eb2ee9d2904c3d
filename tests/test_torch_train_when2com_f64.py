"""When2com det, the whole tiny model's train step with both packages in
float64 (the JAX package's f32 islands kept), the JAX step eager
(``make_train_step(..., jit=False)``): XLA's CPU jit miscompiles the JAX
When2com step in float64 as in f32 (total loss 389.03 jitted, 390.4996
eager and in the port), and an eager float64 step takes about three
minutes, so this file holds that one step. The loss parts to the flagship's
STEP_LOSS_TOL; every gradient leaf to ``chip_smoke.WHEN2COM_F64_GRAD_TOL``
of its scale plus WHEN2COM_F64_GRAD_FLOOR of the largest (the warp grid's
f32 island: tests/train_reference_probes.py); the updated parameters as
tests/test_torch_train_models.py holds them, and the BN running statistics
to 1e-6 x (1 + |v|).
"""

import jax.numpy as jnp
import pytest

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu_torch.config import load_yaml
from tests.torch_port_helpers import CHIP_SMOKE
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats, jax_step,
    labelled_batch, port_step, tiny_hypes, twin, variables_for)


@pytest.fixture(scope="module")
def step_run():
    batch = labelled_batch()
    jh = tiny_hypes(jax_load_yaml, "airv2x_when2com", "det")
    th = tiny_hypes(load_yaml, "airv2x_when2com", "det")
    var = variables_for(jh, batch)
    params, stats, jparts, grads = jax_step(jh, batch, var, dtype=jnp.float64,
                                            jit=False)
    model, parts = port_step(th, batch, var, double=True)
    return dict(model=model, parts=parts, jparts=jparts,
                grads=twin(th, grads, stats, double=True),
                after=twin(th, params, stats, double=True))


def test_when2com_train_step_loss_parts_match_jax_f64(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_when2com_train_step_gradients_match_jax_f64(step_run):
    print("gradients, largest share of the bound", check_gradients(
        step_run["model"], step_run["grads"], CHIP_SMOKE.WHEN2COM_F64_GRAD_TOL,
        CHIP_SMOKE.WHEN2COM_F64_GRAD_FLOOR))


def test_when2com_train_step_params_and_bn_stats_match_jax_f64(step_run):
    assert check_params_and_stats(
        step_run["model"], step_run["after"], step_run["grads"],
        grad_tol=CHIP_SMOKE.WHEN2COM_F64_GRAD_TOL, stat_tol=1e-6) > 0
