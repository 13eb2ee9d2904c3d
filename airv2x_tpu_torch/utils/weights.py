"""Weight bridge: flax variables -> the port's ``state_dict``, and seeded
random weights for runs without a checkpoint.

``load_flax_variables`` inverts the layout rules of
airv2x_tpu/utils/torch_convert.py (torch -> flax):

  * Dense kernel (in, out)                  -> Linear weight (out, in)
  * Conv kernel HWIO                        -> Conv2d weight OIHW
  * 3D Conv kernel DHWIO                    -> Conv3d weight OIDHW
  * ConvTranspose kernel (kh, kw, in, out)  -> ConvTranspose2d weight
    (in, out, kh, kw) with the spatial taps flipped (torch scatters the
    kernel as is, ``lax.conv_transpose`` correlates)
  * BatchNorm params scale / bias and batch_stats mean / var are copied
  * LayerNorm and GroupNorm scale / bias -> weight / bias
  * biases are copied as they are
  * a raw parameter that a module owns itself (V2X-ViT's ``relation_att``,
    ``relation_msg``, ``pos_embedding``) is copied as it is: both packages
    contract it the same way round; or, where the module's ``FLAX_LAYOUT``
    names it, with its axes permuted from flax's channels-last layout to
    the module's (SCOPE's LSTM biases and initial cell state)

Modules are matched to flax scopes by attribute name, renamed where a
module's ``FLAX_NAMES`` says so (flax's auto-names inside ``@nn.compact``,
such as ``Dense_0`` or ``V2XTEncoder_0``, come in that way); a
``ModuleList`` child ``x`` maps to scopes ``x_0``, ``x_1``, ... Modules
applied twice with shared weights are registered once, so each flax leaf
fills exactly one tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from airv2x_tpu_torch.models.nn import MaskedBatchNorm

# modules whose parameters stay f32 under the serving cast, besides those
# whose class sets ``KEEP_F32 = True``: the JAX package keeps f32 parameters
# and computes BatchNorm and LayerNorm statistics and affines in f32
_F32_MODULES = (nn.BatchNorm2d, MaskedBatchNorm, nn.LayerNorm, nn.GroupNorm)


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
    if isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
        return {"weight": v.take("params", scope, "scale"),
                "bias": v.take("params", scope, "bias")}
    kernel = None
    if isinstance(module, nn.Linear):
        kernel = v.take("params", scope, "kernel").T
    elif isinstance(module, nn.Conv3d):
        kernel = v.take("params", scope, "kernel").transpose(4, 3, 0, 1, 2)
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
    layout = getattr(module, "FLAX_LAYOUT", {})
    for name, _ in module.named_parameters(recurse=False):
        t = v.take("params", scope, names.get(name, name))
        out[prefix + name] = t.transpose(layout[name]) if name in layout else t
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


def flax_state_dict(model: nn.Module, variables: dict) -> dict:
    """The bridge's ``{torch name: numpy array}`` for ``model`` from a flax
    ``{"params": ..., "batch_stats": ...}`` tree of (nested dicts of)
    arrays, each a view of its flax leaf in the torch layout. Raises on a
    flax leaf it did not consume."""
    v = _Variables(variables)
    sd: dict = {}
    _walk(model, (), "", v, sd)
    left = v.unused()
    if left:
        raise ValueError(f"flax leaves not consumed by the bridge: {left}")
    return sd


class _LeafPath:
    """Stands in for a flax leaf in ``_walk``: its path, and the bridge's
    layout operations on the way to the torch tensor, which ``to_flax``
    undoes."""

    def __init__(self, path: tuple, ops: tuple = ()):
        self.path, self.ops = path, ops

    @property
    def T(self):  # noqa: N802 (numpy's name)
        return _LeafPath(self.path, self.ops + (("T", None),))

    def __getitem__(self, idx):
        return _LeafPath(self.path, self.ops + (("index", idx),))

    def transpose(self, *axes):
        axes = tuple(axes[0]) if len(axes) == 1 else axes
        return _LeafPath(self.path, self.ops + (("transpose", axes),))

    def to_flax(self, t: np.ndarray) -> np.ndarray:
        """The flax leaf of torch tensor ``t`` (the bridge's layout
        operations inverted, last first)."""
        for op, arg in reversed(self.ops):
            if op == "T":
                t = t.T
            elif op == "index":  # the ConvTranspose taps' flip
                t = t[arg]
            else:
                t = t.transpose(np.argsort(arg))
        return t


class _Paths:
    def take(self, col: str, scope: tuple, key: str) -> _LeafPath:
        return _LeafPath((col,) + scope + (key,))


def flax_paths(model: nn.Module) -> dict:
    """``{torch name: (collection, *flax path)}`` for every tensor the
    bridge fills: the flax leaf each of ``model``'s parameters and
    statistics comes from (``num_batches_tracked``, which flax lacks, left
    out)."""
    out: dict = {}
    _walk(model, (), "", _Paths(), out)
    return {k: v.path for k, v in out.items() if isinstance(v, _LeafPath)}


def flax_variables(model: nn.Module) -> dict:
    """``model``'s weights as a flax ``{"params": ..., "batch_stats": ...}``
    tree of numpy float32 arrays (``flax_state_dict`` inverted), the target
    a reference checkpoint converts into (``utils/torch_convert.py``)."""
    leaves: dict = {}
    _walk(model, (), "", _Paths(), leaves)
    sd = model.state_dict()
    tree: dict = {}
    for name, leaf in leaves.items():
        if not isinstance(leaf, _LeafPath):
            continue
        node = tree
        for p in leaf.path[:-1]:
            node = node.setdefault(p, {})
        t = sd[name].detach().to("cpu", torch.float32).numpy()
        node[leaf.path[-1]] = np.ascontiguousarray(leaf.to_flax(t))
    return tree


def load_flax_variables(model: nn.Module, variables: dict) -> None:
    """Fill ``model`` from a flax variables tree (``flax_state_dict``).

    Raises on a flax leaf it did not consume and, through
    ``load_state_dict(strict=True)``, on a torch tensor it did not fill.
    """
    sd = flax_state_dict(model, variables)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(t)) for k, t in sd.items()},
        strict=True,
    )


def cast_weights_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the model's floating weights to the compute ``dtype`` in place,
    except the parameters and statistics of every BatchNorm-type module
    (``nn.BatchNorm2d`` and its subclass, ``MaskedBatchNorm``), of every
    LayerNorm and GroupNorm and of every module whose class sets ``KEEP_F32`` (its
    submodules included; V2X-ViT's RTE), the own parameters that a module's
    ``F32_PARAMS`` names (SCOPE's LSTM biases and initial cell state), and
    the non-persistent buffers (constants such as the camera frustum), which
    stay f32: the JAX package keeps f32 parameters under a bf16 compute
    dtype and computes these modules in f32, and the conv kernel's BN fold
    (``ConvBNReLU._fold``) reads them in f32.

    For serving only: a model in train mode raises, since rounding its
    weights would round the optimizer's f32 master weights (the train step
    computes in bf16 under ``torch.autocast`` instead)."""
    if any(mod.training for mod in model.modules()):
        raise ValueError("cast_weights_ rounds a serving model's weights; "
                         "call .eval() first (training keeps f32 weights)")
    keep = {id(sub) for mod in model.modules()
            if isinstance(mod, _F32_MODULES) or getattr(mod, "KEEP_F32", False)
            for sub in mod.modules()}
    for mod in model.modules():
        if id(mod) in keep:
            continue
        consts = mod._non_persistent_buffers_set
        own = getattr(mod, "F32_PARAMS", ())
        for t in [p for name, p in mod.named_parameters(recurse=False)
                  if name not in own] + [
                b for name, b in mod.named_buffers(recurse=False)
                if name not in consts]:
            if t.is_floating_point():
                t.data = t.data.to(dtype)
    return model


def init_flax_like_(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's initialisation, drawn from a seeded generator: every
    dense and conv kernel flax's ``lecun_normal`` (a normal of std
    sqrt(1 / fan_in) / 0.8796, truncated at two std; fan_in counts the
    kernel's taps times its input channels), biases zero, BatchNorm scale 1,
    bias 0, running mean 0 and variance 1, LayerNorm scale 1 and bias 0, and
    a module's own raw parameters by its ``flax_init_(g)`` (V2X-ViT's
    relation tensors and position biases, STAMP's ConvNeXt ``gamma`` and
    pixel-wise FC weights), and last, where a module's children take other
    initialisers than these, its ``flax_reinit_()`` (the DSA adapter's
    zero kernels and ring bias). The start of a training run."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d,
                                nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                t = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=g)
                w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.BatchNorm2d, MaskedBatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            else:
                _init_own_leaves_(mod, g)
        for mod in model.modules():
            if hasattr(mod, "flax_reinit_"):
                mod.flax_reinit_()  # children flax initialises otherwise
    return model


def _init_own_leaves_(mod: nn.Module, g: torch.Generator) -> None:
    """flax's initialisers of the leaves that are neither dense, conv nor
    BatchNorm, from ``g``: LayerNorm and GroupNorm scale 1 and bias 0, and
    whatever the
    module's own ``flax_init_(g)`` draws."""
    with torch.no_grad():
        if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif hasattr(mod, "flax_init_"):
            mod.flax_init_(g)


def init_random_(model: nn.Module, seed: int, device="cpu") -> nn.Module:
    """Seeded random weights for a run without a checkpoint: He-normal conv
    and dense weights, small biases, BN affines and statistics around the
    identity with some negative scales (so the pillar encoder's flipped
    channels are exercised); LayerNorms and a module's own raw parameters
    as flax initialises them (``_init_own_leaves_``).

    The draws come from a generator on ``device``: the same seed gives
    other values on the card than on the CPU, and drawing a large model's
    weights on the card spares the host (When2com's 288 M MLP weights)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(t, fn):
        with torch.no_grad():
            t.copy_(fn(torch.empty(t.shape, dtype=torch.float32, device=device)))

    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d,
                                nn.ConvTranspose2d)):
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
        else:
            _init_own_leaves_(mod, g)
    for name, mod in model.named_modules():
        if name.rsplit(".", 1)[-1] == "reg_head":
            # small box deltas: decoded boxes stay near their anchors, as a
            # trained detector's do, so the box filters keep candidates
            with torch.no_grad():
                mod.weight.mul_(1e-3)
                mod.bias.zero_()
    return model
