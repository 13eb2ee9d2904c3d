"""Camera training, continued (tests/test_torch_train_camera_fusions.py
holds the CoBEVT and When2com compositions): the camera trunks and the BEV
encoder in train mode against flax: their running statistics after a
forward at their JAX momenta (0.99 in EfficientNet, 0.9 in the torchvision
parts) and, in float64, their gradients; the momenta of the camera
encoder's Up blocks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from airv2x_tpu.models.camera import lss as jlss
from airv2x_tpu.models.camera import trunks as jtrunks
from airv2x_tpu_torch.models.camera import lss, trunks
from airv2x_tpu_torch.utils.weights import flax_state_dict, load_flax_variables
from tests.test_torch_train import F64_GRAD_TOL
from tests.torch_port_helpers import one_torch_thread, random_variables
from tests.torch_train_helpers import f64_convs_by_taps


# --- the trunks' and the BEV encoder's train mode --------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


MODULES = {
    "EfficientNetB0Features": (jtrunks.EfficientNetB0Features,
                               trunks.EfficientNetB0Features, (2, 64, 96, 3),
                               0.99),
    "ResNet101Trunk": (jtrunks.ResNet101Trunk, trunks.ResNet101Trunk,
                       (2, 64, 96, 3), 0.9),
    "BevEncoder": (lambda **kw: jlss.BevEncoder(out_c=16, **kw),
                   lambda: lss.BevEncoder(16, 16),
                   (2, 32, 48, 16), 0.9),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_camera_module_train_mode_matches_flax(name):
    """One train-mode forward: the outputs, and every BN running statistic
    against flax's updated ``batch_stats`` (1e-5), at the module's momenta,
    which the test also reads off the port's modules (EfficientNet's BNs
    0.99; the torchvision BasicBlock / Bottleneck / stem / Up BNs 0.9)."""
    jcls, tcls, shape, momentum = MODULES[name]
    rng = np.random.default_rng(50)
    x = rng.normal(0.3, 1.0, shape).astype(np.float32)
    jmod, tmod = jcls(), tcls()
    var = random_variables(jmod, x, seed=51, train=False)
    want, upd = jax.jit(lambda v, a: jmod.apply(v, a, train=True,
                                                mutable=["batch_stats"]))(var, x)
    load_flax_variables(tmod, var)
    with torch.no_grad():
        got = tmod.train()(_nchw(x))
    outs = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    for g, w in zip(outs, wants):
        w = np.asarray(w)
        err = np.abs(g.permute(0, 2, 3, 1).numpy() - w).max()
        assert err <= 1e-4 * (1 + np.abs(w).max()), (name, err)
    after = copy.deepcopy(tmod)
    load_flax_variables(after, {"params": var["params"],
                                "batch_stats": upd["batch_stats"]})
    want_bufs = dict(after.named_buffers())
    n = 0
    for bname, b in tmod.named_buffers():
        if bname.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(b.numpy(), want_bufs[bname].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=bname)
        n += 1
    assert n >= 20
    bns = [m for m in tmod.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    if name == "BevEncoder":  # its Up block and BasicBlocks are torchvision's
        assert {m.flax_momentum for m in bns} == {0.9}
    else:
        assert {m.flax_momentum for m in bns} == {momentum}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_camera_module_gradients_match_jax_f64(name):
    """The camera trunks and the BEV encoder in train mode with both
    packages in float64 (JAX's convolutions as
    ``torch_train_helpers.conv_by_taps``): the gradient of every parameter
    to F64_GRAD_TOL of its scale, plus 1e-9 of the largest gradient for the leaves whose
    exact gradient is 0 (a bias that a train-mode BatchNorm follows reads
    rounding noise)."""
    jcls, tcls, shape, _ = MODULES[name]
    rng = np.random.default_rng(52)
    x = rng.normal(0.3, 1.0, shape)
    jmod, tmod = jcls(), tcls()
    var = random_variables(jmod, x.astype(np.float32), seed=53, train=False)
    with jax.enable_x64(True), f64_convs_by_taps():
        jmod64 = jcls(dtype=jnp.float64)
        v64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), var)
        jx = jnp.asarray(x)
        out0 = jax.eval_shape(lambda v, a: jmod64.apply(
            v, a, True, mutable=["batch_stats"])[0], v64, jx)
        rs = [rng.normal(size=o.shape)
              for o in (out0 if isinstance(out0, tuple) else (out0,))]

        def loss(p):
            out, _ = jmod64.apply({"params": p, "batch_stats": v64["batch_stats"]},
                                  jx, True, mutable=["batch_stats"])
            outs = out if isinstance(out, tuple) else (out,)
            return sum(jnp.sum(o * r) for o, r in zip(outs, rs))

        grads = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(v64["params"]))
    load_flax_variables(tmod, var)
    tmod.double().train()
    out = tmod(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    outs = out if isinstance(out, tuple) else (out,)
    sum((o.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum()
        for o, r in zip(outs, rs)).backward()
    want = flax_state_dict(tmod, {"params": grads,
                                  "batch_stats": var["batch_stats"]})
    top = max(np.abs(np.asarray(want[n])).max() for n, _ in tmod.named_parameters())
    for pname, p in tmod.named_parameters():
        w = np.asarray(want[pname])
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= F64_GRAD_TOL * np.abs(w).max() + 1e-9 * top, (pname, err)


def test_cam_encoder_up_blocks_take_torch_momentum():
    enc = lss.CamEncoder(depth_bins=8, context_c=16, downsample=8)
    ups = [m for blk in (enc.up1, enc.up2) for m in blk.modules()
           if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(ups) == 4 and {m.flax_momentum for m in ups} == {0.9}
    eff = [m for m in enc.trunk.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(eff) == 48 and {m.flax_momentum for m in eff} == {0.99}
