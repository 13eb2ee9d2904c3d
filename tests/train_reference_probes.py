"""Probes behind the train-step tests' choices of reference and tolerance
(ROADMAP §3), printed one line each:

  * the JAX When2com det step's total loss jitted by default, jitted with
    XLA_OPT0 (XLA's CPU backend without its LLVM optimisations) and eager,
    against the port's: XLA's CPU jit miscompiles the step;
  * V2X-ViT seg: how far JAX's own f32 gradients and the port's lie from
    JAX's float64 ones, relative to each leaf's scale;
  * how far a one-ulp change of an f32 island moves a tiny model's float64
    gradients, the port against itself (why the whole-model float64
    comparisons of V2X-ViT det and When2com det cannot be tight): for
    V2X-ViT det ``MaskedBatchNorm``'s f32 statistics summed in f32 (the
    order of the sums decides their last bit) instead of accumulated in
    f64 and rounded once; for When2com det the normalized warp's sample
    grid in f64 instead of f32;
  * the V2VNet and When2com float64 det steps with ``jit="spine"`` against
    the eager ones: their times, the loss parts, and the largest
    differences of the gradients, parameters and BN statistics.

Run it from the repository root (CPU, a few minutes):

    JAX_PLATFORMS=cpu python -m tests.train_reference_probes
"""

import time
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import torch

from airv2x_tpu.config import load_yaml as jax_load_yaml
from airv2x_tpu_torch.config import load_yaml
from airv2x_tpu_torch.models import nn as port_nn
from airv2x_tpu_torch.models.fusion import when2com as port_when2com
from airv2x_tpu_torch.ops import warp
from tests.torch_train_helpers import (
    XLA_OPT0, jax_step, labelled_batch, port_step, tiny_hypes, twin,
    variables_for)


def f32_sum_statistics(self, x, mask=None):
    """``MaskedBatchNorm.forward`` with its statistics summed in f32."""
    if not self.training:
        return ORIGINAL_MASKED_BN(self, x, mask)
    m = mask[..., None].to(torch.float32)
    dims = tuple(range(x.dim() - 1))
    cnt = m.sum().clamp_min(1.0)
    xf = x.float()
    mean = (xf * m).sum(dims) / cnt
    var = ((xf - mean) ** 2 * m).sum(dims) / cnt
    with torch.no_grad():
        port_nn._ema_(self.running_mean, mean)
        port_nn._ema_(self.running_var, var)
    inv = torch.rsqrt(var + self.eps).to(x.dtype)
    y = (x - mean.to(x.dtype)) * inv
    return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def f64_grid_warp(src, M, src_index=None):
    """``warp_affine_normalized`` with its sample grid in f64."""
    h, w = src.shape[-3], src.shape[-2]
    lead = src.shape[:-3] if src_index is None else M.shape[:-2]
    ms = M.reshape(-1, 2, 3).double()
    srcs = src.reshape((-1,) + src.shape[-3:])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64),
                            torch.arange(w, dtype=torch.float64), indexing="ij")
    gx = (2.0 * xs + 1.0) / w - 1.0
    gy = (2.0 * ys + 1.0) / h - 1.0
    sxn = ms[:, 0, 0, None, None] * gx + ms[:, 0, 1, None, None] * gy \
        + ms[:, 0, 2, None, None]
    syn = ms[:, 1, 0, None, None] * gx + ms[:, 1, 1, None, None] * gy \
        + ms[:, 1, 2, None, None]
    sx = ((sxn + 1.0) * w - 1.0) * 0.5
    sy = ((syn + 1.0) * h - 1.0) * 0.5
    out = warp.grid_sample_bilinear(srcs, sx, sy, src_index)
    return out.reshape(lead + (h, w, src.shape[-1]))


ORIGINAL_MASKED_BN = port_nn.MaskedBatchNorm.forward


def largest_change(name, patch):
    batch = labelled_batch()
    th = tiny_hypes(load_yaml, name, "det")
    variables = variables_for(tiny_hypes(jax_load_yaml, name, "det"), batch)
    base, _ = port_step(th, batch, variables, double=True)
    with patch():
        moved, _ = port_step(th, batch, variables, double=True)
    ref = dict(base.named_parameters())
    largest = max(np.abs(p.grad.numpy()).max() for p in ref.values())
    worst, leaf = 0.0, ""
    for pname, p in moved.named_parameters():
        g, r = p.grad.numpy(), ref[pname].grad.numpy()
        scale = np.abs(r).max()
        # a leaf whose exact gradient is 0 (a bias a BatchNorm follows, a
        # shift of every agent's score) holds rounding noise only
        if scale > 1e-6 * largest:
            err = np.abs(g - r).max() / scale
            if err > worst:
                worst, leaf = err, pname
    return worst, leaf


def when2com_losses():
    batch = labelled_batch()
    jh = tiny_hypes(jax_load_yaml, "airv2x_when2com", "det")
    variables = variables_for(jh, batch)
    losses = {label: jax_step(jh, batch, variables, **kw)[2]["total_loss"]
              for label, kw in (("jit", {}),
                                ("XLA_OPT0", {"compiler_options": XLA_OPT0}),
                                ("eager", {"jit": False}))}
    _, parts = port_step(tiny_hypes(load_yaml, "airv2x_when2com", "det"), batch,
                         variables)
    losses["port"] = parts["total_loss"]
    print("airv2x_when2com det, f32 total loss: " + ", ".join(
        f"{k} {v:.5f}" for k, v in losses.items()))


def v2xvit_seg_rounding():
    batch = labelled_batch()
    jh = tiny_hypes(jax_load_yaml, "airv2x_v2xvit", "seg")
    th = tiny_hypes(load_yaml, "airv2x_v2xvit", "seg")
    variables = variables_for(jh, batch)
    _, stats32, _, g32 = jax_step(jh, batch, variables)
    _, stats64, _, g64 = jax_step(jh, batch, variables, dtype=jnp.float64)
    port, _ = port_step(th, batch, variables)
    ref = dict(twin(th, g64, stats64, double=True).named_parameters())
    got = {"JAX f32": dict(twin(th, g32, stats32).named_parameters()),
           "port f32": {n: p for n, p in port.named_parameters()}}
    for label, grads in got.items():
        worst = 0.0
        for name, r in ref.items():
            g = grads[name]
            g = (g.grad if label == "port f32" else g).detach().double().numpy()
            r = r.detach().numpy()
            if np.abs(r).max() > 0:  # the HGT type slots no agent uses
                worst = max(worst, np.abs(g - r).max() / np.abs(r).max())
        print(f"airv2x_v2xvit seg: {label} gradients lie up to {worst:.3e} of a "
              "leaf's scale from JAX's float64 ones")


def spine_against_eager(name):
    """The float64 det step with ``jit="spine"`` against the eager one: the
    loss parts equal or not, and the largest difference of a gradient leaf,
    of an updated parameter and of a BN statistic."""
    batch = labelled_batch()
    jh = tiny_hypes(jax_load_yaml, name, "det")
    variables = variables_for(jh, batch)
    runs = {}
    for jit in (False, "spine"):
        t0 = time.perf_counter()
        runs[jit] = jax_step(jh, batch, variables, dtype=jnp.float64, jit=jit)
        runs[jit] += (time.perf_counter() - t0,)
    (p0, s0, l0, g0, t0), (p1, s1, l1, g1, t1) = runs[False], runs["spine"]

    def most(a, b):
        return max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    print(f"{name} det, float64 step: eager {t0:.1f} s, spine {t1:.1f} s; "
          f"loss parts equal {l0 == l1}; largest difference of a gradient "
          f"{most(g0, g1):.3e}, of a parameter {most(p0, p1):.3e}, of a BN "
          f"statistic {most(s0, s1):.3e}")


def main():
    torch.set_num_threads(1)
    for name in ("airv2x_v2vnet", "airv2x_when2com"):
        spine_against_eager(name)
    when2com_losses()
    v2xvit_seg_rounding()
    cases = (
        ("airv2x_v2xvit", "the masked-BN statistics summed in f32",
         lambda: mock.patch.object(port_nn.MaskedBatchNorm, "forward",
                                   f32_sum_statistics)),
        ("airv2x_when2com", "the warp grid in f64",
         lambda: mock.patch.object(port_when2com, "warp_affine_normalized",
                                   f64_grid_warp)),
    )
    for name, what, patch in cases:
        worst, leaf = largest_change(name, patch)
        print(f"{name} det, float64: {what} moves the gradients by up to "
              f"{worst:.3e} of a leaf's scale ({leaf})")


if __name__ == "__main__":
    main()
