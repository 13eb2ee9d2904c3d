"""Camera training, continued (tests/test_torch_train_camera.py holds the
batch, the tolerances and the other compositions): the CoBEVT and When2com
camera compositions' train steps against one JAX ``make_train_step``
update on the CPU in f32, and LSS's camera encoder (depth softmax, lift,
voxel pooling, BEV encoder) in train mode in float64. The camera trunks
and the BEV encoder alone are in tests/test_torch_train_camera_modules.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models.camera import lss as jlss
from airv2x_tpu.models.camera import trunks as jtrunks
from airv2x_tpu_torch.models.camera import lss
from airv2x_tpu_torch.utils.weights import flax_state_dict, load_flax_variables
from tests.test_torch_train import F64_GRAD_TOL
from tests.test_torch_train_camera import (  # noqa: F401 (the batch fixture)
    CAMERA_LOSS_TOL, CAMERA_STAT_TOL, batch, camera_step_run)
from tests.torch_port_helpers import one_torch_thread, random_variables
from tests.torch_train_helpers import (
    check_gradients, check_loss_parts, check_params_and_stats)

CASES = (("airv2x_cobevt", "lidar+cam"), ("airv2x_when2com", "lidar+cam"))


@pytest.fixture(scope="module", params=CASES, ids=[n for n, _ in CASES])
def step_run(request, batch):
    return camera_step_run(batch, *request.param)


def test_camera_train_step_loss_parts_match_jax(step_run):
    check_loss_parts(step_run["parts"], step_run["jparts"], CAMERA_LOSS_TOL)


def test_camera_train_step_gradients_match_jax(step_run):
    check_gradients(step_run["model"], step_run["grads"], step_run["grad_tol"])


def test_camera_train_step_params_and_bn_stats_match_jax(step_run):
    n = check_params_and_stats(step_run["model"], step_run["after"],
                               step_run["grads"], grad_tol=step_run["grad_tol"],
                               stat_tol=CAMERA_STAT_TOL)
    assert n > 100  # the camera encoder's running statistics among them


def _upsample_exact(x, out_h: int, out_w: int):
    """The JAX package's ``upsample_align_corners`` with its sample grid in
    ``x``'s dtype: the package's grid is an f32 island, which in float64
    moves the trunk's gradients by ~1e-3 of their scale through its
    train-mode BatchNorms over four images."""
    def grid(n_in, n_out):
        c = jnp.arange(n_out, dtype=x.dtype) * ((n_in - 1) / (n_out - 1))
        lo = jnp.clip(jnp.floor(c).astype(jnp.int32), 0, n_in - 2)
        return lo, c - lo.astype(x.dtype)

    h, w = x.shape[-3], x.shape[-2]
    ylo, yf = grid(h, out_h)
    xlo, xf = grid(w, out_w)
    yf = yf[:, None, None]
    xy = (jnp.take(x, ylo, axis=-3) * (1 - yf)
          + jnp.take(x, jnp.minimum(ylo + 1, h - 1), axis=-3) * yf)
    xf = xf[:, None]
    return (jnp.take(xy, xlo, axis=-2) * (1 - xf)
            + jnp.take(xy, jnp.minimum(xlo + 1, w - 1), axis=-2) * xf)


def test_lss_camera_encoder_gradients_match_jax_f64(batch, monkeypatch):
    """``LSSCameraEncoder`` (the tiny camera block, LSS's depth head) in
    train mode with both packages in float64 on the batch's first two
    present vehicle camera rigs: the depth head's softmax, the lift, the
    voxel pooling (the port's one ``index_add_``, whose backward is a
    gather; JAX's ``.at[].add``) and the BEV encoder. The geometry stays
    f32 in both, and its points lie more than CELL_MARGIN of a cell from a
    boundary (test_camera_batch_clears_the_cell_margin); JAX's upsampling
    grid runs in float64 (``_upsample_exact``), as the port's
    ``F.interpolate`` does. Every parameter's gradient to F64_GRAD_TOL of
    its scale, plus 1e-9 of the largest (a bias that a train-mode
    BatchNorm follows reads rounding noise); the running statistics after
    the step to 1e-6."""
    from tests.torch_port_helpers import CHIP_SMOKE

    monkeypatch.setattr(jtrunks, "upsample_align_corners", _upsample_exact)
    monkeypatch.setattr(jlss, "upsample_align_corners", _upsample_exact)
    cfg = dict(CHIP_SMOKE.TINY_CAM, use_depth_gt=False)
    mask = np.asarray(batch["agent_mask"], bool)
    cam = {k: np.asarray(v)[mask][:2] for k, v in batch["cam_vehicle"].items()}
    cam64 = dict(cam, imgs=cam["imgs"].astype(np.float64))
    var = random_variables(jlss.LSSCameraEncoder(cfg=cfg), cam, seed=54,
                           train=False)
    with jax.enable_x64(True):
        jmod = jlss.LSSCameraEncoder(cfg=cfg, dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), var)
        jcam = jax.tree.map(jnp.asarray, cam64)
        shape = jax.eval_shape(lambda v: jmod.apply(v, jcam, True,
                                                    mutable=["batch_stats"])[0], v64)
        r = np.random.default_rng(55).normal(size=shape.shape)

        def loss(p):
            out, upd = jmod.apply({"params": p, "batch_stats": v64["batch_stats"]},
                                  jcam, True, mutable=["batch_stats"])
            return jnp.sum(out * r), upd["batch_stats"]

        grads, stats = jax.jit(jax.grad(loss, has_aux=True))(v64["params"])
        grads, stats = jax.tree.map(np.asarray, (grads, stats))
    tmod = lss.LSSCameraEncoder(cfg)
    load_flax_variables(tmod, var)
    tmod.double().train()
    out = tmod({k: torch.from_numpy(v) for k, v in cam64.items()})
    (out * torch.from_numpy(r)).sum().backward()
    want = flax_state_dict(tmod, {"params": grads, "batch_stats": stats})
    top = max(np.abs(np.asarray(want[n])).max() for n, _ in tmod.named_parameters())
    for pname, p in tmod.named_parameters():
        w = np.asarray(want[pname])
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= F64_GRAD_TOL * np.abs(w).max() + 1e-9 * top, (pname, err)
    n = 0
    for bname, b in tmod.named_buffers():
        if bname.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(b.numpy(), np.asarray(want[bname]),
                                       rtol=1e-6, atol=1e-9, err_msg=bname)
            n += 1
    assert n >= 50
