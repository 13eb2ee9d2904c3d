"""Training V2VNet and When2com, whose JAX train steps XLA's CPU jit
(jax / jaxlib 0.9.0) miscompiles (ROADMAP §3): the port's train step, det
and seg, against one JAX ``make_train_step`` update on the CPU in f32,
from one bridged initialisation; V2VNet det in float64; When2com's fusion
in float64 in train mode (the whole When2com det step in float64:
tests/test_torch_train_when2com_f64.py).

The float64 references run eagerly (the V2VNet det step, but for its
spine and optimizer update: ``torch_train_helpers.jax_step(...,
jit="spine")``; ``jax.grad`` of When2com's fusion, but for its policy CNN
and key / query nets); the f32 JAX steps
jit with XLA_OPT0 (XLA's CPU backend without its LLVM optimisations), as an
eager f32 step compiles each primitive alone (about 100 s) and a float64
step at XLA_OPT0 runs for minutes. The port meets both: the eager float64
V2VNet step to F64_GRAD_TOL, the XLA_OPT0 f32 steps to the f32 bounds.
Measured with ``torch_train_helpers.jax_step`` on this batch, the default
jit reads a When2com det total loss of 389.03, XLA_OPT0 390.50, as the
eager step and the port do. The batch and tolerances are
tests/test_torch_train_models.py's, except the gradients of V2VNet seg and
When2com, held at JAX_F32_GRAD_TOL: JAX's own f32 gradients of those lie
further from its float64 ones than the flagship's STEP_GRAD_TOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu.models.fusion.when2com import When2comFusion as JaxWhen2com
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models.fusion.when2com import When2comFusion
from airv2x_tpu_torch.utils.weights import flax_state_dict, load_flax_variables
from tests.test_torch_train import F64_GRAD_TOL, STEP_GRAD_TOL
from tests.torch_port_helpers import CHIP_SMOKE, one_torch_thread, random_variables
from tests.torch_train_helpers import (
    XLA_OPT0, check_f64_gradients, check_gradients, check_loss_parts,
    check_params_and_stats, jax_step, jit_submodules, labelled_batch, port_step,
    run_both, tiny_hypes, twin, variables_for)

CASES = (("airv2x_v2vnet", "det"), ("airv2x_v2vnet", "seg"),
         ("airv2x_when2com", "det"), ("airv2x_when2com", "seg"))
# of a leaf's scale, plus STEP_GRAD_FLOOR of the largest: measured, the JAX
# f32 gradients of these configs (jitted at XLA_OPT0) lie up to 3.4% (V2VNet
# seg), 6.9% (When2com det) and 11.4% (When2com seg, the policy CNN) of a
# leaf's scale from the port's; When2com's policy CNN normalises 8 maps with
# batch statistics and its handshake is a saturated softmax, so f32 rounding
# in either package moves its gradients that far (tests/train_reference_probes.py:
# a one-ulp change of its warp grid moves its float64 gradients by 2.2e-2)
JAX_F32_GRAD_TOL = 0.2
LOOSE = (("airv2x_v2vnet", "seg"), ("airv2x_when2com", "det"),
         ("airv2x_when2com", "seg"))


@pytest.fixture(scope="module")
def batch():
    return labelled_batch()


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{t}" for n, t in CASES])
def step_run(request, batch):
    name, task = request.param
    jh = tiny_hypes(jax_load_yaml, name, task)
    th = tiny_hypes(load_yaml, name, task)
    run = run_both(jh, th, batch, variables_for(jh, batch),
                   compiler_options=XLA_OPT0)
    if (name, task) in LOOSE:
        run["grad_tol"] = JAX_F32_GRAD_TOL
    return run


def test_eager_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"])


def test_eager_train_step_gradients_match_jax(step_run):
    print("gradients, largest share of the bound", check_gradients(
        step_run["model"], step_run["grads"],
        step_run.get("grad_tol", STEP_GRAD_TOL)))


def test_eager_train_step_params_and_bn_stats_match_jax(step_run):
    assert check_params_and_stats(
        step_run["model"], step_run["after"], step_run["grads"],
        grad_tol=step_run.get("grad_tol", STEP_GRAD_TOL)) > 0


def test_v2vnet_gradients_match_jax_f64(batch):
    """V2VNet det with both packages in float64 (the JAX package's f32
    islands kept), the JAX step eager but for its spine: every gradient
    leaf to F64_GRAD_TOL of its scale, and the loss parts as in f32."""
    jh = tiny_hypes(jax_load_yaml, "airv2x_v2vnet", "det")
    th = tiny_hypes(load_yaml, "airv2x_v2vnet", "det")
    var = variables_for(jh, batch)
    _, stats, jparts, grads = jax_step(jh, batch, var, dtype=jnp.float64,
                                       jit="spine")
    model, parts = port_step(th, batch, var, double=True)
    check_loss_parts(parts, jparts)
    check_f64_gradients(model, twin(th, grads, stats, double=True))


def test_when2com_fusion_train_gradients_match_jax_f64(batch):
    """When2com's fusion in train mode (the policy CNN's BNs on batch
    statistics) in float64, JAX eager but for the policy CNN and the key /
    query nets (each jitted, ``jit_submodules``), at 16 x 16 maps of 16
    channels: the gradients of every parameter and of the input maps, and the updated
    running statistics, on the batch's poses and agent mask. Every parameter to F64_GRAD_TOL
    of its scale plus 1e-9 of the largest gradient: the conv biases that a
    BatchNorm follows and the key net's last bias (a shift of every
    agent's score) have exact gradient 0, where both packages read
    rounding noise (~1e-13)."""
    args = dict(CHIP_SMOKE.TINY_FAMILY["airv2x_when2com"]["when2com_fusion"],
                H=16, W=16, in_channels=16)
    rng = np.random.default_rng(70)
    x = rng.normal(0.5, 1.0, (2, 4, 16, 16, 16))
    r = rng.normal(size=(2, 16, 16, 16))
    am = batch["agent_mask"]
    ptf = batch["pairwise_t_full"].astype(np.float64)
    var = random_variables(JaxWhen2com(args=args), x.astype(np.float32), am,
                           ptf.astype(np.float32), seed=71)
    with jax.enable_x64(True):
        jmod = JaxWhen2com(args=args, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), var)

        def loss(p, xx):
            out, upd = jmod.apply({"params": p, "batch_stats": v64["batch_stats"]},
                                  xx, am, ptf, True, mutable=["batch_stats"])
            return jnp.sum(out * r), upd["batch_stats"]

        with jit_submodules(("PolicyNet_0", "key_net", "query_net")):
            (gp, gx), stats = jax.grad(loss, argnums=(0, 1), has_aux=True)(
                v64["params"], jnp.asarray(x))
        gp, gx, stats = jax.tree.map(np.asarray, (gp, gx, stats))
    tmod = When2comFusion(args, 16)
    load_flax_variables(tmod, var)
    tmod.double().train()
    tx = torch.from_numpy(x).permute(0, 1, 4, 2, 3).contiguous().requires_grad_(True)
    out = tmod(tx, torch.from_numpy(am), torch.from_numpy(ptf))
    (out.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum().backward()
    gx_port = tx.grad.permute(0, 1, 3, 4, 2).numpy()
    assert np.abs(gx_port - gx).max() <= F64_GRAD_TOL * np.abs(gx).max()
    want = flax_state_dict(tmod, {"params": gp, "batch_stats": stats})
    top = max(np.abs(np.asarray(want[n])).max() for n, _ in tmod.named_parameters())
    for name, p in tmod.named_parameters():
        w = np.asarray(want[name])
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= F64_GRAD_TOL * np.abs(w).max() + 1e-9 * top, (name, err)
    for name, b in tmod.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), np.asarray(want[name]),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
