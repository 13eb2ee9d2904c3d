"""Weight bridge: flax variables -> the port's ``state_dict``, and seeded
random weights for runs without a checkpoint.

``load_flax_variables`` inverts the layout rules of
airv2x_tpu/utils/torch_convert.py (torch -> flax):

  * Dense kernel (in, out)                  -> Linear weight (out, in)
  * Conv kernel HWIO                        -> Conv2d weight OIHW
  * ConvTranspose kernel (kh, kw, in, out)  -> ConvTranspose2d weight
    (in, out, kh, kw) with the spatial taps flipped (torch scatters the
    kernel as is, ``lax.conv_transpose`` correlates)
  * BatchNorm params scale / bias and batch_stats mean / var are copied
  * biases are copied as they are

Modules are matched to flax scopes by attribute name, renamed where a
module's ``FLAX_NAMES`` says so; a ``ModuleList`` child ``x`` maps to
scopes ``x_0``, ``x_1``, ... Modules applied twice with shared weights are
registered once, so each flax leaf fills exactly one tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from airv2x_tpu_torch.models.heads import DetectionHeads
from airv2x_tpu_torch.models.nn import MaskedBatchNorm


class _Variables:
    """Read access to a flax variables tree that records every leaf read."""

    def __init__(self, variables: dict):
        self.variables = variables
        self.used: set[tuple] = set()

    def take(self, col: str, scope: tuple, key: str) -> np.ndarray:
        tree = self.variables.get(col, {})
        try:
            for s in scope + (key,):
                tree = tree[s]
        except KeyError:
            raise KeyError(f"flax variables lack {col}/{'/'.join(scope + (key,))}")
        self.used.add((col,) + scope + (key,))
        return np.asarray(tree)

    def unused(self) -> list[str]:
        def paths(tree, path):
            for k, v in tree.items():
                if hasattr(v, "items"):
                    yield from paths(v, path + (k,))
                else:
                    yield path + (k,)

        return [
            "/".join(p)
            for col in ("params", "batch_stats")
            for p in paths(self.variables.get(col, {}), (col,))
            if p not in self.used
        ]


def _leaf(module, scope, v: _Variables):
    """The tensors of one leaf module by torch name, or None if not a leaf."""
    if isinstance(module, (nn.BatchNorm2d, MaskedBatchNorm)):
        sd = {
            "weight": v.take("params", scope, "scale"),
            "bias": v.take("params", scope, "bias"),
            "running_mean": v.take("batch_stats", scope, "mean"),
            "running_var": v.take("batch_stats", scope, "var"),
        }
        if isinstance(module, nn.BatchNorm2d):
            sd["num_batches_tracked"] = np.zeros((), np.int64)
        return sd
    kernel = None
    if isinstance(module, nn.Linear):
        kernel = v.take("params", scope, "kernel").T
    elif isinstance(module, nn.ConvTranspose2d):
        kernel = v.take("params", scope, "kernel")[::-1, ::-1].transpose(2, 3, 0, 1)
    elif isinstance(module, nn.Conv2d):
        kernel = v.take("params", scope, "kernel").transpose(3, 2, 0, 1)
    if kernel is None:
        return None
    sd = {"weight": kernel}
    if module.bias is not None:
        sd["bias"] = v.take("params", scope, "bias")
    return sd


def _walk(module, scope: tuple, prefix: str, v: _Variables, out: dict):
    leaf = _leaf(module, scope, v)
    if leaf is not None:
        out.update({prefix + k: t for k, t in leaf.items()})
        return
    names = getattr(module, "FLAX_NAMES", {})
    for name, child in module.named_children():
        if next(child.parameters(), None) is None and next(child.buffers(), None) is None:
            continue  # stateless (e.g. the fusion's communication)
        flax_name = names.get(name, name)
        if isinstance(child, nn.ModuleList):
            for i, sub in enumerate(child):
                _walk(sub, scope + (f"{flax_name}_{i}",), f"{prefix}{name}.{i}.",
                      v, out)
        else:
            _walk(child, scope + (flax_name,), f"{prefix}{name}.", v, out)


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` from a flax ``{"params": ..., "batch_stats": ...}``
    tree of (nested dicts of) arrays.

    Raises on a flax leaf it did not consume and, through
    ``load_state_dict(strict=True)``, on a torch tensor it did not fill.
    """
    v = _Variables(variables)
    sd: dict = {}
    _walk(model, (), "", v, sd)
    left = v.unused()
    if left:
        raise ValueError(f"flax leaves not consumed by the bridge: {left}")
    model.load_state_dict(
        {k: torch.from_numpy(np.array(t)) for k, t in sd.items()},
        strict=True,
    )


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights for a run without a checkpoint: He-normal conv
    and dense weights, small biases, BN affines and statistics around the
    identity with some negative scales (so the pillar encoder's flipped
    channels are exercised)."""
    g = torch.Generator().manual_seed(seed)

    def draw(t, fn):
        with torch.no_grad():
            t.copy_(fn(torch.empty(t.shape, dtype=torch.float32)))

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            # a kernel == stride transposed conv gives each output one tap
            fan_in = w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
            std = math.sqrt(2.0 / fan_in)
            draw(w, lambda t: t.normal_(0.0, std, generator=g))
            if mod.bias is not None:
                draw(mod.bias, lambda t: t.normal_(0.0, 0.1, generator=g))
        elif isinstance(mod, (nn.BatchNorm2d, MaskedBatchNorm)):
            draw(mod.weight, lambda t: t.normal_(1.0, 0.5, generator=g))
            draw(mod.bias, lambda t: t.normal_(0.0, 0.2, generator=g))
            draw(mod.running_mean, lambda t: t.normal_(0.0, 0.2, generator=g))
            draw(mod.running_var, lambda t: t.uniform_(0.5, 2.0, generator=g))
    for mod in model.modules():
        if isinstance(mod, DetectionHeads):
            # small box deltas: decoded boxes stay near their anchors, as a
            # trained detector's do, so the box filters keep candidates
            with torch.no_grad():
                mod.reg_head.weight.mul_(1e-3)
                mod.reg_head.bias.zero_()
    return model
