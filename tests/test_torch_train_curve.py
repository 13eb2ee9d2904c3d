"""The training curve of the tiny flagship, both packages in float64, over
8 steps: one bridged initialisation (``random_variables``, seed 5), one
``make_batch`` stream (seed 11, a new batch each step), the keep fraction
injected at every step, and the AP gate's learning-rate recipe
(airv2x_tpu/tools/chip_ap_gate.py: the tiny config's multistep boundaries
moved to 70/130 and 110/130 of the run, here 4 epochs of 2 steps: lr
0.002, then 2e-4 from step 4 and 2e-5 from step 6). The total loss of
every step must agree to CURVE_TOL: the port's training follows the JAX
package's over a run, not only one step at a time.

Each step's keep fraction is the port's ``chip_smoke.clean_keep_fraction``
of that step's batch at the port's current weights (its cut on a relative
confidence gap of at least 1e-5); the JAX step reads it through a host
callback, so one jitted step serves every value.

The JAX step compiles with the persistent compilation cache off: an entry
of the shared cache directory (tests/conftest.py), compiled for another
machine type, was loaded for this step's float64 program with its
``jax.random.uniform`` replaced by a host callback, and reading the loss
back then failed (``CpuCallback error ... Incorrect output dtype for return
value #0: Expected: float64, Actual: float32``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.data.synthetic import make_batch as jax_make_batch
from airv2x_tpu.loss import build_loss as jax_build_loss
from airv2x_tpu.models.base import SlotLayout as JaxSlotLayout
from airv2x_tpu.ops.anchors import anchor_standup_boxes, generate_anchor_grid
from airv2x_tpu.parallel import train as jax_train
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.data.synthetic import batch_to_torch
from airv2x_tpu_torch.loss import build_loss
from airv2x_tpu_torch.models import build_model
from airv2x_tpu_torch.parallel.train import (
    TrainState, make_optimizer, make_train_step)
from airv2x_tpu_torch.utils.weights import load_flax_variables
from tests.torch_port_helpers import CHIP_SMOKE, TINY, one_torch_thread
from tests.torch_train_helpers import f64, jax_model, variables_for

STEPS = 8
STEPS_PER_EPOCH = 2
EPOCHS = 4
# both packages in float64 with the JAX package's f32 islands (the masked-BN
# statistics, the cell sums, the loss): measured, the totals agree to
# 8.0e-7 relative or better at every one of the 8 steps
CURVE_TOL = 1e-5


def gate_hypes(load):
    """The tiny config with the AP gate's boundaries for EPOCHS epochs."""
    hypes = load(TINY)
    hypes["train_params"]["epoches"] = EPOCHS
    hypes["lr_scheduler"]["step_size"] = [max(int(EPOCHS * 70 / 130), 1),
                                          max(int(EPOCHS * 110 / 130), 2)]
    return hypes


def batches():
    hypes = jax_load_yaml(TINY)
    anchors = generate_anchor_grid(hypes["postprocess"]["anchor_args"])
    rng = np.random.default_rng(11)
    layout = JaxSlotLayout.from_args(hypes["model"]["args"])
    return [jax_make_batch(
        rng, layout, 2, anchors=anchors, anchor_standup=anchor_standup_boxes(anchors),
        target_args=hypes["postprocess"]["target_args"], num_objects=4,
        points_per_agent=512, lidar_range=hypes["preprocess"]["cav_lidar_range"],
        max_boxes=hypes["postprocess"]["max_num"], pts_per_box=40)[0]
        for _ in range(STEPS)]


@pytest.fixture
def no_compilation_cache():
    """The persistent compilation cache off for one test, then restored."""
    was = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", was)


def test_float64_loss_curve_matches_jax(monkeypatch, no_compilation_cache):
    jh, th = gate_hypes(jax_load_yaml), gate_hypes(load_yaml)
    stream = batches()
    variables = variables_for(jh, stream[0])
    schedule = jax_train.make_lr_schedule(jh, STEPS_PER_EPOCH)
    lrs = [float(schedule(i)) for i in range(STEPS)]
    assert lrs[0] == pytest.approx(0.002) and lrs[4] == pytest.approx(2e-4)
    assert lrs[6] == pytest.approx(2e-5)

    # the port: float64, the same variables
    model = build_model(th, device="cpu", train=True).double()
    load_flax_variables(model, jax.tree.map(f64, variables))
    opt, sched = make_optimizer(th, model.parameters(), STEPS_PER_EPOCH)
    assert [sched(i) for i in range(STEPS)] == pytest.approx(lrs)
    state = TrainState(model, opt)
    step = make_train_step(build_loss(th), sched)

    keep = [0.0]
    with jax.enable_x64(True):
        def uniform(key, shape, *args, **kwargs):
            return jax.pure_callback(
                lambda: np.full(shape, keep[0], np.float64),
                jax.ShapeDtypeStruct(shape, jnp.float64))

        monkeypatch.setattr(jax.random, "uniform", uniform)
        jmodel = jax_model(jh, jnp.float64)
        tx, _ = jax_train.make_optimizer(jh, STEPS_PER_EPOCH)
        jstate = jax_train.create_train_state(
            jmodel, jax.tree.map(lambda a: jnp.asarray(f64(a)), variables), tx)
        jstep = jax_train.make_train_step(jmodel, jax_build_loss(jh), tx,
                                          donate=False)
        got, want = [], []
        for batch in stream:
            tb = batch_to_torch(jax.tree.map(f64, batch), "cpu")
            keep[0] = CHIP_SMOKE.clean_keep_fraction(model, tb, 0.5)
            jstate, jparts = jstep(jstate, jax.tree.map(
                lambda a: jnp.asarray(f64(a)), batch), jax.random.PRNGKey(7))
            want.append(float(jparts["total_loss"]))
            got.append(float(step(state, tb, comm_u=torch.full((2,), keep[0]))[
                "total_loss"]))
    assert int(jstate.step) == state.step == STEPS
    rel = np.abs(np.array(got) - np.array(want)) / np.abs(np.array(want))
    print("total loss per step, JAX", want, "relative gap", rel.tolist())
    assert rel.max() <= CURVE_TOL, (got, want)
    assert want[-1] < want[0]  # the run learns
