"""When2com det, the whole tiny model's train step with both packages in
float64 (the JAX package's f32 islands kept), the JAX step eager but for
its spine (``torch_train_helpers.jax_step(..., jit="spine")``: the point
encoder, backbone, shrink conv and heads, the fusion's policy CNN and key /
query nets and the optimizer's update jitted; the warp, the rest of the
fusion, the model's glue and the loss eager): XLA's CPU jit
miscompiles the JAX When2com step in float64 as in f32 (total loss 389.03
jitted, 390.4996 eager and in the port), and the float64 step takes one
to two minutes, so this file holds that one step. The loss parts to the flagship's
STEP_LOSS_TOL; every gradient leaf to ``chip_smoke.WHEN2COM_F64_GRAD_TOL``
of its scale plus WHEN2COM_F64_GRAD_FLOOR of the largest (the warp grid's
f32 island: tests/train_reference_probes.py); the updated parameters as
tests/test_torch_train_models.py holds them, and the BN running statistics
to 1e-6 x (1 + |v|); the loss parts adding up, the handshake's gradients
nonzero, every trained parameter and BN statistic moved. The tests share
the one module-scoped step; torch runs on one thread (``one_torch_thread``),
as in the other heavy port modules.
"""

import jax.numpy as jnp
import pytest

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu_torch.config import load_yaml
from tests.test_torch_train import LR
from tests.torch_port_helpers import CHIP_SMOKE, one_torch_thread
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
                                            jit="spine")
    model, parts = port_step(th, batch, var, double=True)
    return dict(model=model, parts=parts, jparts=jparts,
                wd=float(th["optimizer"]["args"]["weight_decay"]),
                grads=twin(th, grads, stats, double=True),
                after=twin(th, params, stats, double=True),
                before=twin(th, var["params"], var["batch_stats"], double=True))


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


def test_when2com_train_step_loss_parts_add_up_f64(step_run):
    """In both packages the total is the sum of its parts (the loss is an
    f32 island in both: summed in f32, so to f32 rounding)."""
    for parts in (step_run["parts"], step_run["jparts"]):
        rest = sum(v for k, v in parts.items() if k != "total_loss")
        assert parts["total_loss"] == pytest.approx(rest, rel=1e-6)


def test_when2com_handshake_receives_gradients_f64(step_run):
    """At the first step the handshake learns in both packages: the policy
    net, the key and query nets and the query projection have nonzero
    gradients (at full width and the YAMLs' lr it saturates within a few
    steps and its gradient becomes 0: PERF.md, PR 13)."""
    want = dict(step_run["grads"].named_parameters())
    parts = ("fusion_net.policy.", "fusion_net.key_net.",
             "fusion_net.query_net.", "fusion_net.query_proj.")
    seen = set()
    for name, p in step_run["model"].named_parameters():
        if name.startswith(parts):
            assert float(p.grad.abs().max()) > 0, name
            assert float(want[name].detach().abs().max()) > 0, name
            seen.add(name.split(".")[1])
    assert seen == {"policy", "key_net", "query_net", "query_proj"}


def test_when2com_train_step_moves_the_parameters_f64(step_run):
    """Adam moved every parameter whose JAX gradient is nonzero, and each
    entry by at most the learning rate plus the decoupled decay of that
    entry, LR x (1 + wd |p|), in the port: at the first step Adam's update
    is LR g / (|g| + eps), below LR (1e-12 of float64 rounding)."""
    before = dict(step_run["before"].named_parameters())
    grads = dict(step_run["grads"].named_parameters())
    for name, p in step_run["model"].named_parameters():
        p0 = before[name].detach()
        moved = (p.detach() - p0).abs()
        if float(grads[name].detach().abs().max()) > 0:
            assert float(moved.max()) > 0, name
        bound = LR * (1 + step_run["wd"] * p0.abs()) + 1e-12
        assert bool((moved <= bound).all()), (name, float(
            (moved - bound).max()))


def test_when2com_train_step_moves_the_bn_statistics_f64(step_run):
    """Every BatchNorm running mean and variance left its initial value
    (train-mode statistics at the JAX momentum; their values are held to
    JAX's in test_when2com_train_step_params_and_bn_stats_match_jax_f64)."""
    before = dict(step_run["before"].named_buffers())
    n = 0
    for name, b in step_run["model"].named_buffers():
        if name.endswith(("running_mean", "running_var")):
            assert float((b - before[name]).abs().max()) > 0, name
            n += 1
    assert n > 10
