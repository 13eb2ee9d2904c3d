"""Reference PyTorch checkpoint -> the port's model: the counterpart of
airv2x_tpu/utils/torch_convert.py, with its name map whole (the same
``CONVERTERS``, one function per model family).

The map writes a reference (OpenCOOD-layout) state dict into a tree of
flax-layout leaves, with the reference loader's semantics: the ``module.``
prefix of a DDP checkpoint is stripped, a ``model_state_dict`` /
``state_dict`` wrapper is unwrapped, a tensor whose shape does not match its
target is skipped with a warning, and the tensors no target takes are
reported as leftovers. ``load_reference_checkpoint`` builds that tree from
the port model's own tensors (``utils/weights.py:flax_variables``), runs the
map into it and loads the result through the weight bridge, so a skipped
leaf keeps the model's own value.

Tensor layout rules (torch -> flax):
  * Linear weight    (O, I)         -> kernel (I, O)
  * Conv2d weight    (O, I, kh, kw) -> kernel (kh, kw, I, O); Conv3d OIDHW
    -> DHWIO
  * ConvTranspose2d  (I, O, kh, kw) -> kernel (kh, kw, I, O), spatially
    flipped (torch's transposed conv scatters the kernel as it is, flax's
    correlates; the bridge flips it back)
  * BatchNorm weight / bias -> params scale / bias; running_mean / var ->
    batch_stats mean / var

The psm keeps the anchor-major class layout the reference trains with,
which the port's decode reads.

``reference_state_dict`` writes seeded tensors under exactly the key names
and shapes a converter reads for a given target tree, for the tests and the
card's smoke run (no reference checkpoint ships with the repo).
"""

from __future__ import annotations

import logging
import math
from typing import Callable

import numpy as np

log = logging.getLogger(__name__)

# --------------------------------------------------------------------------
# tensor-level converters


def to_np(t) -> np.ndarray:
    if isinstance(t, _Probe):
        return t
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def linear_kernel(w) -> np.ndarray:
    return to_np(w).T


def conv_kernel(w) -> np.ndarray:
    w = to_np(w)
    if isinstance(w, _Probe):
        return w.op("conv")
    if w.ndim == 5:  # Conv3d OIDHW -> DHWIO
        return w.transpose(2, 3, 4, 1, 0)
    return w.transpose(2, 3, 1, 0)


def deconv_kernel(w) -> np.ndarray:
    w = to_np(w)
    return w[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)


# --------------------------------------------------------------------------
# state-dict scoping + flax-tree assignment


def strip_module_prefix(sd: dict) -> dict:
    """DDP saves ``module.``-prefixed keys."""
    if isinstance(sd, _ProbeSD):
        return sd
    return {
        (k[len("module."):] if k.startswith("module.") else k): v
        for k, v in sd.items()
    }


class TorchState:
    """A prefix-scoped view over a torch state dict with consumption
    tracking, so conversion can report exactly which source tensors were
    left unmapped."""

    def __init__(self, sd: dict, prefix: str = "", _consumed: set | None = None):
        self._sd = sd
        self.prefix = prefix
        self.consumed = _consumed if _consumed is not None else set()

    def sub(self, prefix: str) -> "TorchState":
        p = f"{self.prefix}{prefix}" if self.prefix else prefix
        return TorchState(self._sd, p + ".", self.consumed)

    def __contains__(self, key: str) -> bool:
        return self.prefix + key in self._sd

    def get(self, key: str):
        full = self.prefix + key
        self.consumed.add(full)
        return self._sd[full]

    def keys(self):
        return [k for k in self._sd if k.startswith(self.prefix)]

    def leftovers(self):
        return sorted(set(self._sd) - self.consumed)


def _copy_tree(tree):
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


class Assigner:
    """Writes converted tensors into a copy of a flax-layout ``variables``
    tree (nested dicts of arrays; a leaf may be anything with a ``shape``,
    such as the shapes-only tree ``reference_state_dict`` reads).

    A shape mismatch is skipped with a warning, as the reference's partial
    / heterogeneous checkpoint loading does.
    """

    def __init__(self, variables: dict):
        self.variables = _copy_tree(variables)
        self.assigned: list[str] = []
        self.skipped: list[str] = []

    def _resolve(self, col: str, path: tuple):
        node = self.variables.get(col)
        if node is None:
            return None, None
        for p in path[:-1]:
            if not isinstance(node, dict) or p not in node:
                return None, None
            node = node[p]
        if not isinstance(node, dict) or path[-1] not in node:
            return None, None
        return node, path[-1]

    def put(self, col: str, path: tuple, value: np.ndarray):
        name = f"{col}/" + "/".join(path)
        node, leaf = self._resolve(col, path)
        if isinstance(value, _Probe):
            value.sd.col = col
            value.sd.put(value, None if node is None else node[leaf], path)
            return
        if node is None:
            self.skipped.append(f"{name} (missing in target)")
            return
        tgt = node[leaf]
        if tuple(tgt.shape) != tuple(value.shape):
            self.skipped.append(
                f"{name} (shape {tuple(value.shape)} vs target {tuple(tgt.shape)})"
            )
            return
        node[leaf] = value.astype(np.asarray(tgt).dtype)
        self.assigned.append(name)


# --------------------------------------------------------------------------
# the reference state dict a converter reads (tests and the smoke run)


class _Probe:
    """Stands in for the reference tensor ``key`` while a converter runs
    over a ``_ProbeSD``: records the layout operations applied to it on its
    way to ``Assigner.put``."""

    def __init__(self, sd: "_ProbeSD", key: str, ops: tuple = ()):
        self.sd, self.key, self.ops = sd, key, ops

    def op(self, *op) -> "_Probe":
        return _Probe(self.sd, self.key, self.ops + (op,))

    @property
    def T(self):  # noqa: N802 (numpy's name)
        return self.op("T")

    @property
    def shape(self):
        return _ProbeShape()

    def transpose(self, *axes):
        return self.op("transpose", tuple(axes[0]) if len(axes) == 1 else axes)

    def __getitem__(self, idx):
        return self.op("index", idx if isinstance(idx, tuple) else (idx,))

    def reshape(self, *shape):
        return self.op("reshape", shape)


class _ProbeShape:
    """``probe.shape``: its entries are the source tensor's, known only
    once the converter puts the probe."""

    def __getitem__(self, i):
        return ("dim", i)


def _forward_shape(shape: tuple, ops: tuple):
    """The shape ``ops`` turn a source of ``shape`` into."""
    src = shape
    for op in ops:
        if op[0] == "T":
            shape = shape[::-1]
        elif op[0] == "conv":
            perm = (2, 3, 4, 1, 0) if len(shape) == 5 else (2, 3, 1, 0)
            shape = tuple(shape[a] for a in perm)
        elif op[0] == "transpose":
            shape = tuple(shape[a] for a in op[1])
        elif op[0] == "index":
            kept = [d for d, i in zip(shape, op[1]) if isinstance(i, slice)]
            shape = tuple(kept) + shape[len(op[1]):]
        else:  # reshape
            dims = [src[d[1]] if isinstance(d, tuple) else d for d in op[1]]
            if -1 in dims:
                known = math.prod(d for d in dims if d != -1)
                dims[dims.index(-1)] = math.prod(shape) // known
            shape = tuple(dims)
    return shape


def _source_shape(ops: tuple, target: tuple) -> tuple:
    """The reference tensor's shape that ``ops`` turn into ``target``."""
    if not any(op[0] == "reshape" for op in ops):
        shape = target
        for op in reversed(ops):
            if op[0] == "T":
                shape = shape[::-1]
            elif op[0] in ("conv", "transpose"):
                perm = (op[1] if op[0] == "transpose" else
                        (2, 3, 4, 1, 0) if len(shape) == 5 else (2, 3, 1, 0))
                src = [0] * len(perm)
                for i, a in enumerate(perm):
                    src[a] = shape[i]
                shape = tuple(src)
            elif op[0] == "index":  # an integer index drops an axis of 1
                it = iter(shape)
                shape = tuple(next(it) if isinstance(i, slice) else 1
                              for i in op[1]) + tuple(it)
        return shape
    n = math.prod(target)
    for cand in (target[::-1], (target[-1], n // target[-1]),
                 (target[0], n // target[0]), target):
        if _forward_shape(cand, ops) == tuple(target):
            return tuple(cand)
    raise ValueError(f"cannot invert {ops} onto {target}")


class _ProbeSD:
    """A stand-in state dict that answers a converter's questions: every
    key is present unless found absent, and each key read returns a
    ``_Probe``. ``Assigner.put`` reports each probe here with its target."""

    def __init__(self, absent: set, hints: list):
        self.absent, self.hints = absent, hints
        self.queried: set = set()
        self.read: list = []
        self.shapes: dict = {}  # key -> (shape, target path)
        self.missing: list = []  # keys read for a path the target lacks
        self.ranks: dict = {}  # key -> rank of a tensor the map would take
        self.ops: dict = {}  # key -> the layout ops on its way to its leaf
        self.paths: dict = {}  # key -> (collection, *flax path) of its leaf
        self.col = "params"

    def __contains__(self, key):
        self.queried.add(key)
        return key not in self.absent

    def __getitem__(self, key):
        if key in self.absent:
            raise KeyError(key)
        self.read.append(key)
        return _Probe(self, key)

    def __iter__(self):
        return iter(self.hints)

    def put(self, probe: _Probe, target, path: tuple):
        if target is None:
            self.missing.append(probe.key)
            first = probe.ops[0][0] if probe.ops else ""
            self.ranks[probe.key] = {"conv": 4, "T": 2, "index": 4}.get(first, 1)
        else:
            self.shapes[probe.key] = (_source_shape(probe.ops, tuple(target.shape)),
                                      path)
            self.ops[probe.key] = probe.ops
            self.paths[probe.key] = (self.col,) + path


def _to_source(ops: tuple, leaf: np.ndarray, src: tuple) -> np.ndarray:
    """The reference tensor of shape ``src`` that ``ops`` turn into
    ``leaf`` (the ops undone, last first)."""
    shapes = [tuple(src)]
    for i in range(len(ops)):
        shapes.append(_forward_shape(tuple(src), ops[:i + 1]))
    v = leaf
    for op, pre in zip(reversed(ops), reversed(shapes[:-1])):
        if op[0] == "T":
            v = v.T
        elif op[0] in ("conv", "transpose"):
            perm = (op[1] if op[0] == "transpose" else
                    (2, 3, 4, 1, 0) if len(pre) == 5 else (2, 3, 1, 0))
            v = v.transpose(np.argsort(perm))
        elif op[0] == "index":
            out = np.zeros(pre, v.dtype)
            out[op[1]] = v
            v = out
        else:
            v = v.reshape(pre)
    return np.ascontiguousarray(v)


def reference_state_dict(hypes: dict, variables: dict, seed: int = 0,
                         values: bool = False) -> dict:
    """A reference-named state dict for ``hypes``' model whose flax-layout
    tree is ``variables`` (``flax_variables(model)``, or any tree of leaves
    with a ``shape``): every key the converter reads, at the shape that
    fills its target, with seeded float32 values (``numpy``
    ``default_rng(seed)``) of the kind its target holds (He-scaled kernels,
    BatchNorm / LayerNorm scales about 1, positive variances), or with
    ``values`` the tensors that convert into ``variables``' own leaves.

    The converter runs over a stand-in state dict whose keys are all present
    until a key it asked for turns out to have no target, which is then
    taken out, until no such key is left. A key read and never put
    (``num_batches_tracked``, buffers the port rebuilds) becomes a 0
    scalar; a key put, unasked, for a path the target lacks becomes zeros
    of size one in each axis (the converter skips it, as it would a real
    one). The lidar + radar flat models' ``lidar_pillar_vfe`` scope is told
    apart by the target's ``radar_vfe``."""
    convert = CONVERTERS[hypes["model"]["core_method"]]
    hints = (["lidar_pillar_vfe."]
             if "radar_vfe" in variables.get("params", {}) else [])
    absent: set = set()
    for _ in range(1000):
        sd = _ProbeSD(absent, hints)
        convert(sd, variables, hypes)
        gone = {k for k in sd.missing if k in sd.queried} - absent
        if not gone:
            break
        absent |= gone
    else:
        raise RuntimeError("reference_state_dict did not settle")
    rng = np.random.default_rng(seed)
    out = {}
    for key in dict.fromkeys(sd.read):
        if key in sd.ranks:  # put for a path the target lacks: skipped
            out[key] = np.zeros((1,) * sd.ranks[key], np.float32)
            continue
        if key not in sd.shapes:
            out[key] = np.zeros((), np.int64)
            continue
        shape, path = sd.shapes[key]
        leaf = path[-1]
        if values:
            col, *rest = sd.paths[key]
            t = variables[col]
            for p in rest:
                t = t[p]
            out[key] = _to_source(sd.ops[key], np.asarray(t, np.float32), shape)
        elif leaf == "var":
            out[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif leaf == "scale":
            out[key] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif leaf == "kernel":
            fan_in = max(math.prod(shape) // max(shape[0], 1), 1)
            out[key] = (rng.standard_normal(shape)
                        * math.sqrt(2.0 / fan_in)).astype(np.float32)
        else:
            out[key] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return out

# --------------------------------------------------------------------------
# module-level converters (torch scope -> flax paths)


def convert_linear(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("kernel",), linear_kernel(s.get("weight")))
    if "bias" in s:
        asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_conv(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("kernel",), conv_kernel(s.get("weight")))
    if "bias" in s:
        asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_deconv(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("kernel",), deconv_kernel(s.get("weight")))
    if "bias" in s:
        asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_bn(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    """BatchNorm / MaskedBatchNorm: params scale/bias + batch_stats mean/var."""
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("scale",), to_np(s.get("weight")))
    asg.put("params", path + ("bias",), to_np(s.get("bias")))
    asg.put("batch_stats", path + ("mean",), to_np(s.get("running_mean")))
    asg.put("batch_stats", path + ("var",), to_np(s.get("running_var")))
    if "num_batches_tracked" in s:
        s.get("num_batches_tracked")  # consume; flax has no equivalent



def convert_layernorm(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("scale",), to_np(s.get("weight")))
    asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_pillar_vfe(
    ts: TorchState, asg: Assigner, base: tuple, *, fast: bool, num_layers: int = 1
):
    """Reference PillarVFE (airv2x_pillar_vfe.py:52-160: pfn_layers.N with
    linear + BatchNorm1d) -> PillarVFE (PFNLayer_i/Dense_0 +
    MaskedBatchNorm_0) or FastPillarBEV (Dense_0 + MaskedBatchNorm_0)."""
    for i in range(num_layers):
        layer = ts.sub(f"pfn_layers.{i}")
        if fast:
            if num_layers != 1:
                raise ValueError("fast pillar path is single-PFN-layer only")
            dst = base
        else:
            dst = base + (f"PFNLayer_{i}",)
        convert_linear(layer, asg, dst + ("Dense_0",), scope="linear")
        if "norm.weight" in layer:
            convert_bn(layer, asg, dst + ("MaskedBatchNorm_0",), scope="norm")


def convert_bev_backbone(
    ts: TorchState, asg: Assigner, base: tuple, *, layer_nums, upsample_strides=()
):
    """BaseBEVBackbone (base_bev_backbone.py:6-154) -> stages_i/deblocks_i.

    Torch block i is Sequential[ZeroPad2d, Conv, BN, ReLU, (Conv, BN, ReLU)
    x layer_nums[i]] so convs sit at 1+3k and BNs at 2+3k. Deblock i is
    Sequential[ConvTranspose|Conv, BN, ReLU].
    """
    for i, n in enumerate(layer_nums):
        blk = ts.sub(f"blocks.{i}")
        for k in range(n + 1):
            dst = base + (f"stages_{i}", f"ConvBNReLU_{k}")
            convert_conv(blk, asg, dst + ("Conv_0",), scope=f"{1 + 3 * k}")
            convert_bn(blk, asg, dst + ("BatchNorm_0",), scope=f"{2 + 3 * k}")
    n_deblocks = len(upsample_strides)
    for i in range(n_deblocks):
        deb = ts.sub(f"deblocks.{i}")
        if f"deblocks.{i}.0.weight" not in ts:
            continue
        if i >= len(layer_nums):
            dst = base + ("final_deblock",)
        else:
            dst = base + (f"deblocks_{i}",)
        stride = upsample_strides[i]
        if stride >= 1:
            convert_deconv(deb, asg, dst + ("ConvTranspose_0",), scope="0")
        else:
            convert_conv(deb, asg, dst + ("Conv_0",), scope="0")
        convert_bn(deb, asg, dst + ("BatchNorm_0",), scope="1")


def convert_downsample_conv(ts: TorchState, asg: Assigner, base: tuple, *, n_layers):
    """DownsampleConv (downsample_conv.py:35-53): layers.i.double_conv.{0,2}
    -> DoubleConv_i/Conv_{0,1}."""
    for i in range(n_layers):
        dc = ts.sub(f"layers.{i}.double_conv")
        dst = base + (f"DoubleConv_{i}",)
        convert_conv(dc, asg, dst + ("Conv_0",), scope="0")
        convert_conv(dc, asg, dst + ("Conv_1",), scope="2")


def convert_naive_compressor(ts: TorchState, asg: Assigner, base: tuple):
    """NaiveCompressor (naive_compress.py): encoder.{0,1} + decoder.{0,1,3,4}
    -> Conv_i/BatchNorm_i, i in 0..2."""
    for i, (scope_conv, scope_bn) in enumerate(
        [("encoder.0", "encoder.1"), ("decoder.0", "decoder.1"),
         ("decoder.3", "decoder.4")]
    ):
        convert_conv(ts, asg, base + (f"Conv_{i}",), scope=scope_conv)
        convert_bn(ts, asg, base + (f"BatchNorm_{i}",), scope=scope_bn)


def convert_det_heads(ts: TorchState, asg: Assigner, base: tuple = ("heads",)):
    for head in ("cls_head", "reg_head", "obj_head"):
        if f"{head}.weight" in ts:
            convert_conv(ts, asg, base + (head,), scope=head)


def convert_seg_head(ts: TorchState, asg: Assigner, base: tuple = ("seg_head",)):
    for head in ("dynamic_head", "static_head"):
        if f"seg_head.{head}.weight" in ts:
            convert_conv(ts, asg, base + (head,), scope=f"seg_head.{head}")


def _encoder_scopes(args: dict):
    """Yield (agent_type, modality, torch_scope) for the reference's
    per-type encoder ModuleLists (airv2x_base_model.py:36-103):
    ``{veh,rsu,drone}_models.<modality_index>`` — lidar entries are
    Sequential(PillarVFE, Scatter) so the VFE lives at ``.0``."""
    prefix = {"vehicle": "veh_models", "rsu": "rsu_models", "drone": "drone_models"}
    for t in ("vehicle", "rsu", "drone"):
        if t not in args.get("collaborators", []):
            continue
        for mi, m in enumerate(args[t]["modalities"]):
            scope = f"{prefix[t]}.{mi}"
            yield t, m, (scope + ".0") if m == "lidar" else scope


def convert_hetero_encoder(ts: TorchState, asg: Assigner, args: dict):
    """Per-agent-type lidar encoders -> encoder/{type}_pillar_vfe."""
    pre = args.get("preprocess") or {}
    fast_cfg = bool((pre.get("args") or {}).get("fast_pillars", True))
    for t, m, scope in _encoder_scopes(args):
        if m == "lidar":
            nf = args[t]["lidar"]["pillar_vfe"]["num_filters"]
            fast = fast_cfg and len(nf) == 1
            convert_pillar_vfe(
                ts.sub(scope),
                asg,
                ("encoder", f"{t}_pillar_vfe"),
                fast=fast,
                num_layers=len(nf),
            )
        elif m == "cam":
            convert_lss_encoder(
                ts.sub(scope), asg, ("encoder", f"{t}_lss"), args[t]["cam"]
            )


# --------------------------------------------------------------------------
# camera branch (LSS): EfficientNet-b0 / truncated resnet101 trunks,
# resnet18 BevEncode (sub_modules/lss_submodule.py; flax twins in
# models/camera/{trunks,lss}.py)

EFFNET_B0_EXPANDS = (
    # per-block expand ratios, flattened from the b0 stage table
    [1] + [6] * 15
)


def convert_mbconv(ts: TorchState, asg: Assigner, base: tuple, *, expand: int):
    if expand != 1:
        convert_conv(ts, asg, base + ("expand_conv",), scope="_expand_conv")
        convert_bn(ts, asg, base + ("bn0",), scope="_bn0")
    convert_conv(ts, asg, base + ("depthwise_conv",), scope="_depthwise_conv")
    convert_bn(ts, asg, base + ("bn1",), scope="_bn1")
    convert_conv(ts, asg, base + ("se_reduce",), scope="_se_reduce")
    convert_conv(ts, asg, base + ("se_expand",), scope="_se_expand")
    convert_conv(ts, asg, base + ("project_conv",), scope="_project_conv")
    convert_bn(ts, asg, base + ("bn2",), scope="_bn2")


def convert_efficientnet_features(ts: TorchState, asg: Assigner, base: tuple):
    """efficientnet_pytorch trunk -> EfficientNetB0Features. The classifier
    head tensors (_conv_head/_bn1/_fc, unused by CamEncode.get_eff_features)
    are consumed without mapping."""
    convert_conv(ts, asg, base + ("conv_stem",), scope="_conv_stem")
    convert_bn(ts, asg, base + ("bn0",), scope="_bn0")
    for i, expand in enumerate(EFFNET_B0_EXPANDS):
        convert_mbconv(
            ts.sub(f"_blocks.{i}"), asg, base + (f"block{i}",), expand=expand
        )
    for key in list(ts.keys()):
        rel = key[len(ts.prefix):]
        if rel.split(".")[0] in ("_conv_head", "_bn1", "_fc"):
            ts.get(rel)


def convert_up_block(ts: TorchState, asg: Assigner, base: tuple):
    """lss_submodule.Up -> UpBlock (conv Sequential indices 0/1/3/4)."""
    convert_conv(ts, asg, base + ("conv0",), scope="conv.0")
    convert_bn(ts, asg, base + ("bn0",), scope="conv.1")
    convert_conv(ts, asg, base + ("conv1",), scope="conv.3")
    convert_bn(ts, asg, base + ("bn1",), scope="conv.4")


def _convert_torch_resblock(ts: TorchState, asg: Assigner, base: tuple,
                            convs: int):
    for i in range(1, convs + 1):
        convert_conv(ts, asg, base + (f"conv{i}",), scope=f"conv{i}")
        convert_bn(ts, asg, base + (f"bn{i}",), scope=f"bn{i}")
    if "downsample.0.weight" in ts:
        convert_conv(ts, asg, base + ("ds_conv",), scope="downsample.0")
        convert_bn(ts, asg, base + ("ds_bn",), scope="downsample.1")


def convert_resnet101_trunk(ts: TorchState, asg: Assigner, base: tuple):
    """Truncated torchvision resnet101 (conv1..layer2) -> ResNet101Trunk."""
    convert_conv(ts, asg, base + ("conv1",), scope="conv1")
    convert_bn(ts, asg, base + ("bn1",), scope="bn1")
    for i in range(3):
        _convert_torch_resblock(
            ts.sub(f"layer1.{i}"), asg, base + (f"layer1_{i}",), convs=3
        )
    for i in range(4):
        _convert_torch_resblock(
            ts.sub(f"layer2.{i}"), asg, base + (f"layer2_{i}",), convs=3
        )


def convert_bevencode(ts: TorchState, asg: Assigner, base: tuple):
    """lss_submodule.BevEncode -> BevEncoder."""
    convert_conv(ts, asg, base + ("conv1",), scope="conv1")
    convert_bn(ts, asg, base + ("bn1",), scope="bn1")
    for layer in (1, 2, 3):
        for i in range(2):
            _convert_torch_resblock(
                ts.sub(f"layer{layer}.{i}"), asg,
                base + (f"layer{layer}_{i}",), convs=2,
            )
    convert_up_block(ts.sub("up1"), asg, base + ("up1",))
    convert_conv(ts, asg, base + ("up2_conv",), scope="up2.1")
    convert_bn(ts, asg, base + ("up2_bn",), scope="up2.2")
    convert_conv(ts, asg, base + ("up2_out",), scope="up2.4")


def convert_cam_encoder(ts: TorchState, asg: Assigner, base: tuple,
                        cam_cfg: dict):
    """lss_submodule.CamEncode / CamEncode_Resnet101 -> CamEncoder."""
    enc_type = str(cam_cfg.get("camera_encoder", "EfficientNet"))
    if enc_type == "Resnet101":
        convert_resnet101_trunk(ts, asg, base + ("trunk",))
    else:
        convert_efficientnet_features(ts.sub("trunk"), asg, base + ("trunk",))
        convert_up_block(ts.sub("up1"), asg, base + ("up1",))
        if int(cam_cfg.get("img_downsample", 16)) == 8:
            convert_up_block(ts.sub("up2"), asg, base + ("up2",))
    convert_conv(ts, asg, base + ("image_head",), scope="image_head")
    if "depth_head.weight" in ts:
        convert_conv(ts, asg, base + ("depth_head",), scope="depth_head")


def convert_lss_encoder(ts: TorchState, asg: Assigner, base: tuple,
                        cam_cfg: dict):
    """airv2x_encoder.LiftSplatShootEncoder -> LSSCameraEncoder."""
    convert_cam_encoder(ts.sub("camencode"), asg, base + ("camencode",), cam_cfg)
    convert_bevencode(ts.sub("bevencode"), asg, base + ("bevencode",))


# --------------------------------------------------------------------------
# model-family converters


def _convert_airv2x_trunk(ts: TorchState, asg: Assigner, args: dict):
    """The shared Airv2xBase spine: per-type encoders, BEV backbone, shrink
    conv, compressor, det/seg heads — identical across the AirV2X model
    family (each model file repeats this block)."""
    convert_hetero_encoder(ts, asg, args)

    # cobevt/sicp keep trunk keys at the args top level (airv2x_cobevt.py:37)
    mod = args.get("modality_fusion") or args
    bb = mod["base_bev_backbone"]
    convert_bev_backbone(
        ts.sub("backbone"),
        asg,
        ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
    )

    shrink = mod.get("shrink_header", {})
    if shrink.get("use"):
        convert_downsample_conv(
            ts.sub("shrink_conv"), asg, ("shrink_conv",), n_layers=len(shrink["dim"])
        )
    if int(mod.get("compression", 0) or 0) > 0:
        convert_naive_compressor(ts.sub("naive_compressor"), asg, ("compressor",))

    if args["task"] == "det":
        convert_det_heads(ts, asg)
    else:
        convert_seg_head(ts, asg)


def convert_airv2x_where2comm(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xWhere2com (models/airv2x_where2com.py) -> Airv2xWhere2comm."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)

    # fusion_net: AttentionFusion has no parameters; the gaussian comm filter
    # is a frozen constant we re-derive analytically (where2comm_fuse.py:66-81)
    for k in list(ts.sub("fusion_net").keys()):
        ts.consumed.add(k)
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_policy_net(ts: TorchState, asg: Assigner, base: tuple):
    """policy_net4 (when2com.py:288-308): conv{1..5}.cbr_unit.{0 conv,1 bn}
    -> PolicyNet_0/_ConvBNRelu_{0..4}/{Conv_0, BatchNorm_0}."""
    for i in range(5):
        blk = ts.sub(f"conv{i + 1}.cbr_unit")
        dst = base + (f"_ConvBNRelu_{i}",)
        convert_conv(blk, asg, dst + ("Conv_0",), scope="0")
        convert_bn(blk, asg, dst + ("BatchNorm_0",), scope="1")


def convert_km_generator(
    ts: TorchState, asg: Assigner, base: tuple, *, feat_hw: tuple
):
    """km_generator (when2com.py:270-286): fc.{0,2,4} -> Dense_{0,1,2}.

    The first Linear flattens the (256, h, w) torch NCHW map; our flax twin
    flattens NHWC, so its input features are permuted (C,H,W) -> (H,W,C).
    """
    h, w = feat_hw
    w0 = to_np(ts.get("fc.0.weight"))  # (256, 256*h*w) over (C, H, W) order
    w0 = (
        w0.reshape(-1, 256, h, w).transpose(0, 2, 3, 1).reshape(w0.shape[0], -1)
    )
    asg.put("params", base + ("Dense_0", "kernel"), w0.T)
    asg.put("params", base + ("Dense_0", "bias"), to_np(ts.get("fc.0.bias")))
    convert_linear(ts, asg, base + ("Dense_1",), scope="fc.2")
    convert_linear(ts, asg, base + ("Dense_2",), scope="fc.4")


def convert_airv2x_when2com(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xWhen2com (models/airv2x_when2com.py) -> When2com twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)

    w2c = args["when2com_fusion"]
    feat_hw = (int(w2c["H"]) // 4, int(w2c["W"]) // 4)
    fus = ts.sub("fusion_net")
    convert_policy_net(
        fus.sub("query_key_net"), asg, ("fusion_net", "PolicyNet_0")
    )
    convert_km_generator(
        fus.sub("key_net"), asg, ("fusion_net", "key_net"), feat_hw=feat_hw
    )
    convert_km_generator(
        fus.sub("query_net"), asg, ("fusion_net", "query_net"), feat_hw=feat_hw
    )
    convert_linear(fus, asg, ("fusion_net", "Dense_0"), scope="attention_net.linear")

    asg.torch_leftovers = ts.leftovers()
    return asg


def _convert_flat_trunk(ts: TorchState, asg: Assigner, args: dict):
    """Shared flat-family trunk: pillar vfe(s) + backbone + shrink/compress
    + det heads + (optional) disconet pixel-weight stack. The lidar VFE
    lands at flax key ``vfe`` (PointPillarBase attribute name); the _lrf
    variants' ``lidar_pillar_vfe``/``radar_pillar_vfe`` torch scopes map to
    ``vfe``/``radar_vfe`` (point_pillar_v2xvit_lrf.py:20-33)."""
    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    if any(k.startswith("lidar_pillar_vfe.") for k in ts.keys()):
        convert_pillar_vfe(
            ts.sub("lidar_pillar_vfe"), asg, ("vfe",), fast=fast,
            num_layers=len(nf),
        )
        convert_pillar_vfe(
            ts.sub("radar_pillar_vfe"), asg, ("radar_vfe",), fast=fast,
            num_layers=len(nf),
        )
    else:
        convert_pillar_vfe(
            ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast, num_layers=len(nf)
        )
    bb = args["base_bev_backbone"]
    convert_bev_backbone(
        ts.sub("backbone"),
        asg,
        ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
    )
    # att_bev_backbone.py:362-364 per-stage AutoEncoder bottlenecks
    compress_layer = int(bb.get("compression", 0))
    for i in range(compress_layer):
        if i >= len(bb["layer_nums"]):
            break
        convert_autoencoder(
            ts.sub(f"backbone.compression_modules.{i}"), asg,
            (f"stage_compressors_{i}",), layer_num=compress_layer - i,
        )
    shrink = args.get("shrink_header", {})
    if shrink.get("use") or (
        shrink and "use" not in shrink and "dim" in shrink
    ):  # reference configs omit 'use'; presence of the block enables it
        convert_downsample_conv(
            ts.sub("shrink_conv"), asg, ("shrink_conv",), n_layers=len(shrink["dim"])
        )
    if int(args.get("compression", 0)) > 0:
        convert_naive_compressor(ts.sub("naive_compressor"), asg, ("compressor",))
    # flat family keeps the 1x1 heads at model top level (no 'heads' nest)
    convert_det_heads(ts, asg, base=())
    # disconet pixel weight stack (point_pillar_disconet.py:176-199)
    if "pixel_weight_layer.conv1_1.weight" in ts:
        pw = ts.sub("pixel_weight_layer")
        for i in range(1, 4):
            convert_conv(
                pw, asg, ("pixel_weight", f"Conv_{i - 1}"), scope=f"conv1_{i}"
            )
            convert_bn(
                pw, asg, ("pixel_weight", f"BatchNorm_{i - 1}"),
                scope=f"bn1_{i}",
            )
        convert_conv(pw, asg, ("pixel_weight", "Conv_3"), scope="conv1_4")


def _flat_converter(fusion_fn=None):
    """Build a flat-family converter: trunk + optional fusion-net mapping;
    unconverted fusion/communication scopes are consumed (frozen gaussian
    filters and other param-less blocks)."""

    def convert(sd: dict, variables: dict, hypes: dict) -> Assigner:
        args = dict(hypes["model"]["args"])
        args.setdefault("preprocess", hypes.get("preprocess"))
        ts = TorchState(strip_module_prefix(sd))
        asg = Assigner(variables)
        _convert_flat_trunk(ts, asg, args)
        if fusion_fn is not None:
            fusion_fn(ts, asg, args)
        for scope in ("fusion_net", "naive_communication"):
            for k in list(ts.sub(scope).keys()):
                ts.consumed.add(k)
        asg.torch_leftovers = ts.leftovers()
        return asg

    return convert


def convert_diffusion_unet(ts: TorchState, asg: Assigner, base: tuple,
                           cfg: dict):
    """mdd_modules/unet.DiffusionUNet -> models/fusion/mdd.DiffusionUNet.

    Walks the same level/block structure the constructor builds
    (unet.py:217-300); ``resolution`` is hardcoded 128 upstream (:198), so
    attention placement depends only on the config's attn_resolutions."""

    def resblock(scope: str, path: tuple):
        s = ts.sub(scope)
        convert_layernorm(s, asg, path + ("norm1",), scope="norm1")
        convert_conv(s, asg, path + ("conv1",), scope="conv1")
        convert_linear(s, asg, path + ("temb_proj",), scope="temb_proj")
        convert_layernorm(s, asg, path + ("norm2",), scope="norm2")
        convert_conv(s, asg, path + ("conv2",), scope="conv2")
        for short in ("nin_shortcut", "conv_shortcut"):
            if f"{short}.weight" in s:
                convert_conv(s, asg, path + (short,), scope=short)

    def attnblock(scope: str, path: tuple):
        s = ts.sub(scope)
        convert_layernorm(s, asg, path + ("norm",), scope="norm")
        for name in ("q", "k", "v", "proj_out"):
            convert_conv(s, asg, path + (name,), scope=name)

    ch_mult = tuple(cfg["ch_mult"])
    n_lv = len(ch_mult)
    nrb = int(cfg["num_res_blocks"])
    attn = set(cfg.get("attn_resolutions", ()))
    curr_res = 128
    convert_conv(ts, asg, base + ("conv_in",), scope="conv_in")
    convert_linear(ts, asg, base + ("temb_dense_0",), scope="temb.dense.0")
    convert_linear(ts, asg, base + ("temb_dense_1",), scope="temb.dense.1")
    for i in range(n_lv):
        for j in range(nrb):
            resblock(f"down.{i}.block.{j}", base + (f"down_{i}_block_{j}",))
            if curr_res in attn:
                attnblock(f"down.{i}.attn.{j}",
                          base + (f"down_{i}_attn_{j}",))
        if i != n_lv - 1:
            convert_conv(ts, asg, base + (f"down_{i}_downsample", "conv"),
                         scope=f"down.{i}.downsample.conv")
            curr_res //= 2
    resblock("mid.block_1", base + ("mid_block_1",))
    resblock("mid.block_2", base + ("mid_block_2",))
    for i in reversed(range(n_lv)):
        for j in range(nrb + 1):
            resblock(f"up.{i}.block.{j}", base + (f"up_{i}_block_{j}",))
            if curr_res in attn:
                attnblock(f"up.{i}.attn.{j}", base + (f"up_{i}_attn_{j}",))
        if i != 0:
            convert_conv(ts, asg, base + (f"up_{i}_upsample", "conv"),
                         scope=f"up.{i}.upsample.conv")
            curr_res *= 2
    convert_layernorm(ts, asg, base + ("norm_out",), scope="norm_out")
    convert_conv(ts, asg, base + ("conv_out",), scope="conv_out")


def convert_autoencoder(ts: TorchState, asg: Assigner, base: tuple, *,
                        layer_num: int):
    """common_modules/auto_encoder.AutoEncoder -> alignnet.AutoEncoder.

    Encoder level i = [ZeroPad, Conv s2, BN, ReLU, Conv, BN, ReLU]
    (auto_encoder.py:14-45); the decoder runs REVERSED (forward :84-89), so
    torch decoder[L-1-j] lands at the flax module's j-th decode iteration."""
    for i in range(layer_num):
        enc = ts.sub(f"encoder.{i}")
        convert_conv(enc, asg, base + (f"Conv_{2 * i}",), scope="1")
        convert_bn(enc, asg, base + (f"BatchNorm_{2 * i}",), scope="2")
        convert_conv(enc, asg, base + (f"Conv_{2 * i + 1}",), scope="4")
        convert_bn(enc, asg, base + (f"BatchNorm_{2 * i + 1}",), scope="5")
    for j in range(layer_num):
        dec = ts.sub(f"decoder.{layer_num - 1 - j}")
        convert_deconv(dec, asg, base + (f"ConvTranspose_{j}",), scope="0.0")
        convert_bn(
            dec, asg, base + (f"BatchNorm_{2 * layer_num + 2 * j}",),
            scope="0.1",
        )
        convert_conv(
            dec, asg, base + (f"Conv_{2 * layer_num + j}",), scope="1.0"
        )
        convert_bn(
            dec, asg, base + (f"BatchNorm_{2 * layer_num + 2 * j + 1}",),
            scope="1.1",
        )


def _flat_mdd_fusion(ts, asg, args):
    """Cond_Diff_Denoise scope: the UNet parameters convert; the diffusion
    schedule buffers (betas/alphas_cumprod/posterior_*,
    radar_cond_diff_denoise.py:283-322) are constants recomputed on the flax
    side (mdd.mdd_beta_schedule) and are consumed, not mapped."""
    convert_diffusion_unet(
        ts.sub("mdd.denoiser"), asg, ("mdd", "denoiser"),
        dict(args["mdd_block"]["model"]),
    )
    for k in list(ts.sub("mdd").keys()):
        if ".denoiser." not in k:
            ts.consumed.add(k)


def _conv1d_as_dense(ts: TorchState, asg: Assigner, path: tuple, scope: str):
    """1x1 Conv1d == Dense: weight (out, in, 1) -> kernel (in, out)."""
    w = to_np(ts.get(f"{scope}.weight"))[:, :, 0].T
    asg.put("params", path + ("kernel",), w)
    if f"{scope}.bias" in ts:
        asg.put("params", path + ("bias",), to_np(ts.get(f"{scope}.bias")))


def convert_point_pillar_interf(sd: dict, variables: dict,
                                hypes: dict) -> Assigner:
    """PointPillarInterF (point_pillar_InterF.py) -> faithful flax twin:
    InterFVFE is parameter-less (pure point augmentation); interRAL's
    shared q/k Conv1d collapses to one Dense (q_conv.weight IS
    k_conv.weight upstream, Inter_pillar_vfe.py:16); BatchNorm1d ->
    MaskedBatchNorm."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)
    ir = ts.sub("interral")
    convert_linear(ir, asg, ("inter_ral", "shared_linear"), scope="linear")
    _conv1d_as_dense(ir, asg, ("inter_ral", "qk_conv"), "q_conv")
    ir.get("k_conv.weight")  # alias of q_conv.weight — consume
    _conv1d_as_dense(ir, asg, ("inter_ral", "v_conv"), "v_conv")
    _conv1d_as_dense(ir, asg, ("inter_ral", "trans_conv"), "trans_conv")
    convert_bn(ir, asg, ("inter_ral", "MaskedBatchNorm_0"),
               scope="after_norm")
    bb = args["base_bev_backbone"]
    convert_bev_backbone(
        ts.sub("backbone"), asg, ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
    )
    convert_det_heads(ts, asg, base=())
    for k in list(ts.sub("backbone.fuse_modules").keys()):
        ts.consumed.add(k)
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_mgf_backbone(ts: TorchState, asg: Assigner, base: tuple, *,
                         layer_nums, upsample_strides):
    """l4dr_modules/att_bev_backbone.AttBEVBackbone_MGF -> MGFBackbone:
    three stage stacks + three deblock sets + the per-level sigmoid
    self-gates; the fuse_modules AttFusion is parameter-less."""
    for prefix, stage in (("blocks", "stages"), ("L_blocks", "l_stages"),
                          ("R_blocks", "r_stages")):
        for i, n in enumerate(layer_nums):
            blk = ts.sub(f"{prefix}.{i}")
            for k in range(n + 1):
                dst = base + (f"{stage}_{i}", f"ConvBNReLU_{k}")
                convert_conv(blk, asg, dst + ("Conv_0",), scope=f"{1 + 3 * k}")
                convert_bn(blk, asg, dst + ("BatchNorm_0",),
                           scope=f"{2 + 3 * k}")
    for prefix, deb_name in (("deblocks", "deblocks"),
                             ("L_deblocks", "l_deblocks"),
                             ("R_deblocks", "r_deblocks")):
        for i, stride in enumerate(upsample_strides):
            deb = ts.sub(f"{prefix}.{i}")
            if f"{prefix}.{i}.0.weight" not in ts:
                continue
            dst = base + (f"{deb_name}_{i}",)
            if stride >= 1:
                convert_deconv(deb, asg, dst + ("ConvTranspose_0",),
                               scope="0")
            else:
                convert_conv(deb, asg, dst + ("Conv_0",), scope="0")
            convert_bn(deb, asg, dst + ("BatchNorm_0",), scope="1")
    for i in range(len(layer_nums)):
        convert_conv(ts.sub(f"Conv_LG.{i}"), asg,
                     base + (f"lg_convs_{i}",), scope="0")
        convert_conv(ts.sub(f"Conv_RG.{i}"), asg,
                     base + (f"rg_convs_{i}",), scope="0")


def convert_point_pillar_l4dr(sd: dict, variables: dict,
                              hypes: dict) -> Assigner:
    """PointPillarL4DR (point_pillar_L4DR.py) -> faithful flax twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)
    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("lidar_pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    convert_pillar_vfe(ts.sub("radar_pillar_vfe"), asg, ("radar_vfe",),
                       fast=fast, num_layers=len(nf))
    bb = args["base_bev_backbone"]
    convert_mgf_backbone(
        ts.sub("backbone"), asg, ("mgf",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
    )
    convert_det_heads(ts, asg, base=())
    for k in list(ts.sub("backbone.fuse_modules").keys()):
        ts.consumed.add(k)
    asg.torch_leftovers = ts.leftovers()
    return asg


def _flat_spatialcooper_fusion(ts, asg, args):
    # spatial_cooper_fuse.SpatialFusion: one Conv3d(2->1) in a Sequential
    convert_conv(ts.sub("fusion_net.conv3d"), asg, ("spatial_fuse3d",),
                 scope="0")


def _flat_v2xvit_fusion(ts, asg, args):
    convert_v2xt_encoder(
        ts.sub("fusion_net.encoder"),
        asg,
        ("fusion_net", "V2XTEncoder_0"),
        args["transformer"]["encoder"],
    )


def _flat_cobevt_fusion(ts, asg, args):
    convert_swap_fusion(
        ts.sub("fusion_net"),
        asg,
        ("fusion_net",),
        depth=int(args["fax_fusion"]["depth"]),
    )


def _flat_v2vnet_fusion(ts, asg, args):
    convert_v2vnet_fusion(ts.sub("fusion_net"), asg, ("fusion_net",))


def _flat_when2com_fusion(ts, asg, args):
    w2c = args["when2com_fusion"]
    feat_hw = (int(w2c["H"]) // 4, int(w2c["W"]) // 4)
    fus = ts.sub("fusion_net")
    convert_policy_net(
        fus.sub("query_key_net"), asg, ("fusion_net", "PolicyNet_0")
    )
    convert_km_generator(
        fus.sub("key_net"), asg, ("fusion_net", "key_net"), feat_hw=feat_hw
    )
    convert_km_generator(
        fus.sub("query_net"), asg, ("fusion_net", "query_net"), feat_hw=feat_hw
    )
    convert_linear(fus, asg, ("fusion_net", "Dense_0"),
                   scope="attention_net.linear")


def _flat_sicp_fusion(ts, asg, args):
    convert_sicp_fusion(ts.sub("fusion_net"), asg, ("fusion_net",))


convert_point_pillar_intermediate = _flat_converter()
convert_point_pillar_intermediate.__doc__ = (
    "point_pillar{,_early,_max,_intermediate,_where2comm}.py — shared flat"
    " trunk; max/att/where2comm fusions carry no learned params beyond the"
    " frozen gaussian comm filter."
)
convert_point_pillar_v2xvit = _flat_converter(_flat_v2xvit_fusion)
convert_point_pillar_cobevt = _flat_converter(_flat_cobevt_fusion)
convert_point_pillar_v2vnet = _flat_converter(_flat_v2vnet_fusion)
convert_point_pillar_when2com = _flat_converter(_flat_when2com_fusion)
convert_point_pillar_sicp = _flat_converter(_flat_sicp_fusion)




def convert_swap_fusion(ts: TorchState, asg: Assigner, base: tuple, *, depth: int):
    """SwapFusionEncoder (cobevt_modules/swap_fusion_modules.py:233-284,
    mask variant :130-196) -> SwapFusionEncoder twin.

    Per depth block: window_attention/window_ffd/grid_attention/grid_ffd,
    each PreNormResidual(norm + fn). Attention fn: to_qkv, to_out.0, and an
    Embedding bias table (copied verbatim — the relative index tables are
    constructed identically on both sides). FeedForward fn: net.{0,3}.
    """
    for i in range(depth):
        blk = ts.sub(f"layers.{i}")
        dst = base + (f"SwapFusionBlock_{i}",)
        for j, (att, ffd) in enumerate(
            [("window_attention", "window_ffd"), ("grid_attention", "grid_ffd")]
        ):
            a = blk.sub(att)
            convert_layernorm(a, asg, dst + (f"LayerNorm_{2 * j}",), scope="norm")
            att_dst = dst + (f"WindowedAgentAttention_{j}",)
            convert_linear(a, asg, att_dst + ("Dense_0",), scope="fn.to_qkv")
            convert_linear(a, asg, att_dst + ("Dense_1",), scope="fn.to_out.0")
            asg.put(
                "params",
                att_dst + ("relative_position_bias",),
                to_np(a.get("fn.relative_position_bias_table.weight")),
            )
            if "fn.relative_position_index" in a:
                # registered buffer; rebuilt analytically on our side
                a.get("fn.relative_position_index")
            f = blk.sub(ffd)
            convert_layernorm(
                f, asg, dst + (f"LayerNorm_{2 * j + 1}",), scope="norm"
            )
            ff_dst = dst + (f"_FeedForward_{j}",)
            convert_linear(f, asg, ff_dst + ("Dense_0",), scope="fn.net.0")
            convert_linear(f, asg, ff_dst + ("Dense_1",), scope="fn.net.3")

    convert_layernorm(ts, asg, base + ("LayerNorm_0",), scope="mlp_head.2")
    convert_linear(ts, asg, base + ("Dense_0",), scope="mlp_head.3")


def convert_airv2x_cobevt(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xCoBEVT (models/airv2x_cobevt.py) -> CoBEVT twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)
    convert_swap_fusion(
        ts.sub("fusion_net"),
        asg,
        ("fusion_net",),
        depth=int(args["fax_fusion"]["depth"]),
    )
    asg.torch_leftovers = ts.leftovers()
    return asg




def convert_hgt_attention(ts: TorchState, asg: Assigner, base: tuple,
                          num_types: int = 2):
    """HGTCavAttention (hmsa.py:6-158): typed q/k/v/a ModuleLists + the
    relation_att / relation_msg tensors (copied verbatim; our factored
    per-edge-type contraction is algebraically identical)."""
    for t in range(num_types):
        convert_linear(ts, asg, base + (f"q_{t}",), scope=f"q_linears.{t}")
        convert_linear(ts, asg, base + (f"k_{t}",), scope=f"k_linears.{t}")
        convert_linear(ts, asg, base + (f"v_{t}",), scope=f"v_linears.{t}")
        convert_linear(ts, asg, base + (f"a_{t}",), scope=f"a_linears.{t}")
    asg.put("params", base + ("relation_att",), to_np(ts.get("relation_att")))
    asg.put("params", base + ("relation_msg",), to_np(ts.get("relation_msg")))


def convert_pyramid_window(ts: TorchState, asg: Assigner, base: tuple,
                           *, n_scales: int, split_attn: bool):
    """PyramidWindowAttention (mswin.py:102-145): pwmsa.{i} BaseWindow
    attentions + optional SplitAttn."""
    for i in range(n_scales):
        wa = ts.sub(f"pwmsa.{i}")
        dst = base + (f"BaseWindowAttention_{i}",)
        convert_linear(wa, asg, dst + ("Dense_0",), scope="to_qkv")
        asg.put(
            "params", dst + ("pos_embedding",), to_np(wa.get("pos_embedding"))
        )
        convert_linear(wa, asg, dst + ("Dense_1",), scope="to_out.0")
    if split_attn:
        sa = ts.sub("split_attn")
        dst = base + ("SplitAttn_0",)
        convert_linear(sa, asg, dst + ("Dense_0",), scope="fc1")
        convert_layernorm(sa, asg, dst + ("LayerNorm_0",), scope="bn1")
        convert_linear(sa, asg, dst + ("Dense_1",), scope="fc2")


def convert_v2xt_encoder(ts: TorchState, asg: Assigner, base: tuple, cfg: dict):
    """V2XTEncoder (v2xvit_basic.py:135-200) -> V2XTEncoder twin."""
    cav = cfg["cav_att_config"]
    pw = cfg["pwindow_att_config"]
    n_scales = len(pw["heads"])
    use_split = pw["fusion_method"] == "split_attn"

    if cav.get("use_RTE"):
        rte = ts.sub("rte.emb")
        convert_linear(rte, asg, base + ("RTE_0", "lin"), scope="lin")
        if "emb.weight" in rte:
            rte.get("emb.weight")  # frozen sinusoid table, rebuilt analytically
    # prior_feed is constructed upstream but never called in forward
    # (v2xvit_basic.py:155 vs :173-200) — dead parameters
    for k in ("prior_feed.weight", "prior_feed.bias"):
        if k in ts:
            ts.get(k)

    for d in range(int(cfg["depth"])):
        layer = ts.sub(f"layers.{d}")
        blk_dst = base + (f"V2XFusionBlock_{d}",)
        blk = layer.sub("0")
        for b in range(int(cfg["num_blocks"])):
            inner = blk.sub(f"layers.{b}")
            convert_layernorm(
                inner, asg, blk_dst + (f"LayerNorm_{2 * b}",), scope="0.norm"
            )
            att = inner.sub("0.fn")
            att_dst = blk_dst + (
                f"HGTCavAttention_{b}" if cav.get("use_hetero")
                else f"CavAttention_{b}",
            )
            if cav.get("use_hetero"):
                convert_hgt_attention(att, asg, att_dst)
            else:
                convert_linear(att, asg, att_dst + ("Dense_0",), scope="to_qkv")
                convert_linear(att, asg, att_dst + ("Dense_1",), scope="to_out.0")
            convert_layernorm(
                inner, asg, blk_dst + (f"LayerNorm_{2 * b + 1}",), scope="1.norm"
            )
            convert_pyramid_window(
                inner.sub("1.fn"),
                asg,
                blk_dst + (f"PyramidWindowAttention_{b}",),
                n_scales=n_scales,
                split_attn=use_split,
            )
        ff = layer.sub("1")
        convert_layernorm(ff, asg, base + (f"LayerNorm_{d}",), scope="norm")
        convert_linear(ff, asg, base + (f"Dense_{2 * d}",), scope="fn.net.0")
        convert_linear(ff, asg, base + (f"Dense_{2 * d + 1}",), scope="fn.net.3")


def convert_airv2x_v2xvit(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xV2XViT (models/airv2x_v2xvit.py) -> V2XTransformer twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)
    convert_v2xt_encoder(
        ts.sub("fusion_net.encoder"),
        asg,
        ("fusion_net", "V2XTEncoder_0"),
        args["transformer"]["encoder"],
    )
    asg.torch_leftovers = ts.leftovers()
    return asg




def convert_v2vnet_fusion(ts: TorchState, asg: Assigner, base: tuple):
    """V2VNetFusion (v2v_fuse.py:18-195): msg conv, single-layer ConvGRU
    (cell_list.0.conv_gates/conv_can), output MLP."""
    convert_conv(ts, asg, base + ("Conv_0",), scope="msg_cnn")
    gru = ts.sub("conv_gru.cell_list.0")
    convert_conv(gru, asg, base + ("ConvGRUCell_0", "Conv_0"), scope="conv_gates")
    convert_conv(gru, asg, base + ("ConvGRUCell_0", "Conv_1"), scope="conv_can")
    convert_linear(ts, asg, base + ("Dense_0",), scope="mlp")


def convert_airv2x_v2vnet(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xV2VNet (models/airv2x_v2vnet.py) -> V2VNet twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)
    convert_v2vnet_fusion(ts.sub("fusion_net"), asg, ("fusion_net",))
    asg.torch_leftovers = ts.leftovers()
    return asg




def convert_resnet_backbone(
    ts: TorchState, asg: Assigner, base: tuple, *, layer_nums,
    upsample_strides=(), resnext: bool = False, nested: bool = False,
    layer_base: int = 0,
):
    """ResNetBEVBackbone / PyramidFusion trunk (sub_modules/resblock.py,
    base_bev_backbone_resnet.py): resnet.layer{i}.{j} blocks + deblocks.

    ``nested`` adds the extra 'resnet' level our PyramidFusion wraps the
    backbone in (the plain flax ResNetBEVBackbone keeps stages at its top).
    """
    block = "BottleneckX" if resnext else "BasicBlock"
    n_convs = 3 if resnext else 2
    inner = ("resnet",) if nested else ()
    for i, n in enumerate(layer_nums):
        for j in range(n):
            blk = ts.sub(f"resnet.layer{i + layer_base}.{j}")
            dst = base + inner + (f"stages_{i}", f"{block}_{j}")
            for k in range(n_convs):
                convert_conv(blk, asg, dst + (f"Conv_{k}",), scope=f"conv{k + 1}")
                convert_bn(
                    blk, asg, dst + (f"BatchNorm_{k}",), scope=f"bn{k + 1}"
                )
            if f"resnet.layer{i + layer_base}.{j}.downsample.0.weight" in ts:
                convert_conv(
                    blk, asg, dst + (f"Conv_{n_convs}",), scope="downsample.0"
                )
                convert_bn(
                    blk, asg, dst + (f"BatchNorm_{n_convs}",), scope="downsample.1"
                )
    for i, stride in enumerate(upsample_strides):
        deb = ts.sub(f"deblocks.{i}")
        if f"deblocks.{i}.0.weight" not in ts:
            continue
        dst = base + inner + (f"deblocks_{i}",)
        if stride >= 1:
            convert_deconv(deb, asg, dst + ("ConvTranspose_0",), scope="0")
        else:
            convert_conv(deb, asg, dst + ("Conv_0",), scope="0")
        convert_bn(deb, asg, dst + ("BatchNorm_0",), scope="1")


def convert_pyramid_fusion(ts: TorchState, asg: Assigner, base: tuple, cfg: dict):
    """PyramidFusion (fuse_modules/pyramid_fuse.py:64-166): ResNeXt trunk +
    per-level occupancy heads."""
    convert_resnet_backbone(
        ts,
        asg,
        base,
        layer_nums=cfg["layer_nums"],
        upsample_strides=cfg.get("upsample_strides", ()),
        resnext=bool(cfg.get("resnext")),
        nested=True,
    )
    for i in range(len(cfg["layer_nums"])):
        if f"single_head_{i}.weight" in ts:
            convert_conv(ts, asg, base + (f"single_head_{i}",), scope=f"single_head_{i}")


def convert_airv2x_heal(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xHEAL (models/airv2x_heal.py) -> HEAL twin: per-type encoders,
    single-stage ResNet modality backbone, pyramid fusion, shrink, heads."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    convert_hetero_encoder(ts, asg, args)
    mod = args.get("modality_fusion") or args
    bb = mod["base_bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"),
        asg,
        ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
        resnext=False,
    )
    convert_pyramid_fusion(
        ts.sub("pyramid_backbone"), asg, ("pyramid",), args["fusion_backbone"]
    )
    shrink = mod.get("shrink_header", {})
    if shrink.get("use"):
        convert_downsample_conv(
            ts.sub("shrink_conv"), asg, ("shrink_conv",), n_layers=len(shrink["dim"])
        )
    if args["task"] == "det":
        convert_det_heads(ts, asg)
    else:
        convert_seg_head(ts, asg)
    asg.torch_leftovers = ts.leftovers()
    return asg




def convert_convnext_adapter(ts: TorchState, asg: Assigner, base: tuple,
                             n_blocks: int):
    """AdapterConvNext (fuse_modules/adapter.py:120-140 + the ConvNeXt
    stack of feature_alignnet_modules.py:299-360)."""
    convert_conv(ts, asg, base + ("Conv_0",), scope="channel_convert1")
    for i in range(n_blocks):
        blk = ts.sub(f"conv.model.{i}")
        dst = base + (f"_ConvNeXtBlock_{i}",)
        convert_conv(blk, asg, dst + ("Conv_0",), scope="dwconv")
        convert_layernorm(blk, asg, dst + ("LayerNorm_0",), scope="norm")
        convert_linear(blk, asg, dst + ("Dense_0",), scope="pwconv1")
        convert_linear(blk, asg, dst + ("Dense_1",), scope="pwconv2")
        asg.put("params", dst + ("gamma",), to_np(blk.get("gamma")))
    convert_conv(ts, asg, base + ("Conv_1",), scope="channel_convert2")
    # the smoothing conv is constructed upstream but never applied in
    # AdapterConvNext.forward (adapter.py:132 vs :134-144) — dead params
    for k in ("smoothing.weight", "smoothing.bias"):
        if k in ts:
            ts.get(k)


def convert_airv2x_stamp(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xSTAMP (models/airv2x_stamp.py) -> STAMP twin: HEAL trunk +
    per-type adapters (identity / convnext supported)."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    convert_hetero_encoder(ts, asg, args)
    mod = args.get("modality_fusion") or args
    bb = mod["base_bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"),
        asg,
        ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
        resnext=False,
    )
    convert_pyramid_fusion(
        ts.sub("pyramid_backbone"), asg, ("pyramid",), args["fusion_backbone"]
    )
    type_map = {"vehicle": "adapter_vehicle", "rsu": "adapter_rsu",
                "drone": "adapter_drone"}
    for t, scope in type_map.items():
        acfg = (args.get(t) or {}).get("adapter")
        if not acfg or f"{scope}.adapter.channel_convert1.weight" not in ts:
            # identity adapters carry no params; consume nothing
            continue
        aa = acfg.get("args", {})
        n_blocks = int(
            aa.get("submodule_args", {}).get(
                "num_of_blocks", aa.get("submodule_args", {}).get("depth", 2)
            )
        )
        convert_convnext_adapter(
            ts.sub(f"{scope}.adapter"),
            asg,
            (f"adapter_{t}", "AdapterConvNext_0"),
            n_blocks,
        )
    shrink = mod.get("shrink_header", {})
    if shrink.get("use"):
        convert_downsample_conv(
            ts.sub("shrink_conv"), asg, ("shrink_conv",), n_layers=len(shrink["dim"])
        )
    if args["task"] == "det":
        convert_det_heads(ts, asg)
    else:
        convert_seg_head(ts, asg)
    asg.torch_leftovers = ts.leftovers()
    return asg




def convert_sicp_fusion(ts: TorchState, asg: Assigner, base: tuple):
    """MultiSpatialFusion (sicpfuse_modules/multiagent_sicp_fuse.py:20-44):
    compChannels1 / conv1 / conv2 / compChannels2, each Conv+BN."""
    for i, scope in enumerate(
        ("compChannels1", "conv1", "conv2", "compChannels2")
    ):
        blk = ts.sub(scope)
        dst = base + (f"_ConvBN_{i}",)
        convert_conv(blk, asg, dst + ("Conv_0",), scope="0")
        convert_bn(blk, asg, dst + ("BatchNorm_0",), scope="1")


def convert_airv2x_sicp(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xSiCP (models/airv2x_sicp.py; trunk keys live at the args top
    level like cobevt) -> SiCP twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    _convert_airv2x_trunk(ts, asg, args)
    convert_sicp_fusion(ts.sub("fusion_net"), asg, ("fusion_net",))
    asg.torch_leftovers = ts.leftovers()
    return asg


# --------------------------------------------------------------------------
# How2comm (how2comm_modules/*): flow generator, mutual communication,
# STCFormer with deformable query refinement


def _consume_scope(ts: TorchState, scope: str):
    for k in list(ts.sub(scope).keys()):
        ts.consumed.add(k)


def convert_conv1d_as_dense(ts: TorchState, asg: Assigner, path: tuple, *,
                            scope: str):
    """torch Conv1d(C, C, kernel=1) -> flax Dense."""
    s = ts.sub(scope)
    asg.put("params", path + ("kernel",), to_np(s.get("weight"))[:, :, 0].T)
    if "bias" in s:
        asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_temporal_attention(ts: TorchState, asg: Assigner, base: tuple):
    """stcformer.TemporalAttention (:25-77)."""
    for n in ("conv_query", "conv_key", "conv_value", "conv_feat"):
        convert_conv(ts, asg, base + (n,), scope=n)
    for n in ("conv_temporal_key", "conv_temporal_value"):
        convert_conv1d_as_dense(ts, asg, base + (n,), scope=n)


def convert_deform_encoder(ts: TorchState, asg: Assigner, base: tuple, *,
                           depth: int = 1):
    """RPN_transformer_deformable_mtf_singlescale (:430-524) ->
    DeformableQueryRefine. The per-layer self-attention block (layers.{i}.0)
    is constructed but never used in the reference forward — consumed."""
    convert_linear(ts, asg, base + ("transformer", "pos_embedding"),
                   scope="pos_embedding")
    for i in range(depth):
        lay = ts.sub(f"transformer_layer.layers.{i}")
        _consume_scope(lay, "0")  # unused PreNorm(Attention)
        convert_layernorm(lay, asg,
                          base + ("transformer", f"layer{i}_ca_norm"),
                          scope="1.norm")
        ca = lay.sub("1.fn.cross_attn")
        for n in ("sampling_offsets", "attention_weights", "value_proj",
                  "output_proj"):
            convert_linear(
                ca, asg,
                base + ("transformer", f"layer{i}_cross_attn", n), scope=n,
            )
        convert_layernorm(lay, asg,
                          base + ("transformer", f"layer{i}_ff_norm"),
                          scope="2.norm")
        convert_linear(lay, asg,
                       base + ("transformer", f"layer{i}_ff", "fc1"),
                       scope="2.fn.net.0")
        convert_linear(lay, asg,
                       base + ("transformer", f"layer{i}_ff", "fc2"),
                       scope="2.fn.net.3")


def convert_stcformer(ts: TorchState, asg: Assigner, base: tuple):
    """stcformer.STCFormer (:148-205). The per-level nn.LayerNorm is unused
    in the reference forward — consumed."""
    convert_temporal_attention(
        ts.sub("temporal_self_attention"), asg,
        base + ("temporal_self_attention",),
    )
    convert_linear(ts, asg, base + ("time_embedding",), scope="time_embedding")
    for enc in ("exclusive_encoder", "common_encoder"):
        convert_deform_encoder(ts.sub(enc), asg, base + (enc,))
    convert_conv(ts, asg, base + ("late_fusion", "gate_1"),
                 scope="late_fusion.gate_1")
    convert_conv(ts, asg, base + ("late_fusion", "gate_2"),
                 scope="late_fusion.gate_2")
    _consume_scope(ts, "layer_norm")


def convert_flow_generator(ts: TorchState, asg: Assigner, base: tuple, *,
                           bb_cfg: dict):
    """feature_flow.FlowGenerator (:346-421): ResNetModified backbone +
    deblocks (+ the extra //6 deblock) + ReduceInfTC pre-encoder."""
    for li, n in enumerate(bb_cfg["layer_nums"]):
        for bi in range(n):
            _convert_torch_resblock(
                ts.sub(f"backbone.resnet.layer{li + 1}.{bi}"), asg,
                base + ("backbone", f"layer{li}_{bi}"), convs=2,
            )
    n_up = len(bb_cfg["upsample_strides"])
    for i in range(n_up):
        convert_deconv(ts, asg, base + ("backbone", f"deblock{i}_deconv"),
                       scope=f"backbone.deblocks.{i}.0")
        convert_bn(ts, asg, base + ("backbone", f"deblock{i}_bn"),
                   scope=f"backbone.deblocks.{i}.1")
    convert_deconv(ts, asg, base + ("backbone", "final_deconv"),
                   scope=f"backbone.deblocks.{n_up}.0")
    convert_bn(ts, asg, base + ("backbone", "final_bn"),
               scope=f"backbone.deblocks.{n_up}.1")
    pe = ts.sub("pre_encoder")
    for n in ("conv1_2", "conv1_3", "conv1_4", "conv_flow", "conv_scale"):
        convert_conv(pe, asg, base + ("pre_encoder", n), scope=n)
    for n in ("bn1_2", "bn1_3", "bn1_4", "bn2_1", "bn2_2", "bn2_3"):
        convert_bn(pe, asg, base + ("pre_encoder", n), scope=n)
    for n in ("deconv2_1", "deconv2_2", "deconv2_3"):
        convert_deconv(pe, asg, base + ("pre_encoder", n), scope=n)


def convert_mutual_communication(ts: TorchState, asg: Assigner, base: tuple):
    """mutual_communication.Communication (:92-269); the fixed gaussian
    filter is regenerated on the flax side — consumed."""
    convert_conv(ts, asg, base + ("ch_mlp_0",),
                 scope="channel_request.sharedMLP.0")
    convert_conv(ts, asg, base + ("ch_mlp_1",),
                 scope="channel_request.sharedMLP.2")
    convert_conv(ts, asg, base + ("spatial_request",),
                 scope="spatial_request.conv")
    convert_conv(ts, asg, base + ("channel_fusion",), scope="channel_fusion")
    convert_conv(ts, asg, base + ("spatial_fusion",), scope="spatial_fusion")
    for i in (1, 2, 3):
        convert_conv(ts, asg, base + (f"stat_conv{i}",),
                     scope=f"statisticsNetwork.conv{i}")
    _consume_scope(ts, "gaussian_filter")


def convert_point_pillar_how2comm(sd: dict, variables: dict,
                                  hypes: dict) -> Assigner:
    """PointPillarHow2comm (models/point_pillar_how2comm.py) -> faithful
    flax twin (models/how2comm_model.py)."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    bb = args["base_bev_backbone"]
    if "resnet" in bb:
        convert_resnet_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    else:
        convert_bev_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    shrink = args.get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    convert_det_heads(ts, asg, base=())

    fn = ts.sub("fusion_net")
    convert_conv(fn, asg, ("channel_fuse",), scope="channel_fuse")
    convert_flow_generator(fn.sub("how2comm.flow"), asg, ("flow",),
                           bb_cfg=args["base_bev_backbone"])
    convert_mutual_communication(fn.sub("how2comm.commu_module"), asg,
                                 ("commu_module",))
    _consume_scope(fn.sub("how2comm"), "commu_module.gaussian_filter")
    _consume_scope(fn, "naive_communication")
    for i in range(len(args["fusion_args"]["num_filters"])):
        convert_stcformer(fn.sub(f"fuse_modules.{i}"), asg,
                          (f"stcformer_{i}",))
    asg.torch_leftovers = ts.leftovers()
    return asg


# --------------------------------------------------------------------------
# SCOPE (scope_modules/*): LSTM temporal fusion, confidence-masked
# collaboration, deformable per-level fusion, late confidence blending


def convert_stpn(ts: TorchState, asg: Assigner, base: tuple):
    """temporal_fusion_lstm.STPN_MotionLSTM (:118-208)."""
    for n in ("1_1", "1_2", "2_1", "2_2", "7_1", "7_2", "8_1", "8_2"):
        convert_conv(ts, asg, base + (f"conv{n}",), scope=f"conv{n}")
        convert_bn(ts, asg, base + (f"bn{n}",), scope=f"bn{n}")


def convert_sync_lstm(ts: TorchState, asg: Assigner, base: tuple):
    """temporal_fusion_lstm.SyncLSTM (:11-79)."""
    for n in ("pre_1", "pre_2", "after_1", "after_2"):
        convert_conv(ts, asg, base + (f"conv_{n}",), scope=f"conv_{n}")
        convert_bn(ts, asg, base + (f"bn_{n}",), scope=f"bn_{n}")
    # init_c (cs, H, W) -> (H, W, cs)
    asg.put("params", base + ("init_c",),
            to_np(ts.get("init_c")).transpose(1, 2, 0))
    cell = ts.sub("lstmcell")
    for g in ("i", "f", "c", "o"):
        convert_stpn(cell.sub(f"U_{g}"), asg, base + ("lstmcell", f"u_{g}"))
        convert_stpn(cell.sub(f"V_{g}"), asg, base + ("lstmcell", f"v_{g}"))
        # bias (1, C, H, W) -> (1, H, W, C)
        asg.put("params", base + ("lstmcell", f"b_{g}"),
                to_np(cell.get(f"b_{g}")).transpose(0, 2, 3, 1))


def convert_encode_layer(ts: TorchState, asg: Assigner, base: tuple):
    """where2comm_attn.EncodeLayer (:79-118)."""
    asg.put("params", base + ("in_proj_weight",),
            to_np(ts.get("attn.in_proj_weight")))
    asg.put("params", base + ("in_proj_bias",),
            to_np(ts.get("attn.in_proj_bias")))
    convert_linear(ts, asg, base + ("out_proj",), scope="attn.out_proj")
    convert_linear(ts, asg, base + ("linear1",), scope="linear1")
    convert_linear(ts, asg, base + ("linear2",), scope="linear2")
    convert_layernorm(ts, asg, base + ("norm1",), scope="norm1")
    convert_layernorm(ts, asg, base + ("norm2",), scope="norm2")


def convert_point_pillar_where2comm_bm2cp(sd: dict, variables: dict,
                                          hypes: dict) -> Assigner:
    """PointPillarWhere2comm (models/point_pillar_where2comm_bm2cp.py, the
    where2comm_attn variant) -> PointPillarWhere2commAttn."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    bb = args["base_bev_backbone"]
    if "resnet" in bb:
        convert_resnet_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    else:
        convert_bev_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    shrink = args.get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    convert_det_heads(ts, asg, base=())
    fn = ts.sub("fusion_net")
    _consume_scope(fn, "naive_communication")
    fa = args["fusion_args"]
    if str((fa.get("agg_operator") or {}).get("mode")) == "Transformer":
        n = len(fa["num_filters"]) if fa.get("multi_scale", True) else 1
        for i in range(n):
            convert_encode_layer(
                fn.sub(f"fuse_modules.{i}.encode_layer"), asg,
                (f"transformer_fuse_{i}", "encode_layer"),
            )
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_conv3d(ts: TorchState, asg: Assigner, path: tuple, *, scope=""):
    """torch Conv3d weight (O, I, kd, kh, kw) -> flax (kd, kh, kw, I, O)."""
    s = ts.sub(scope) if scope else ts
    asg.put("params", path + ("kernel",),
            to_np(s.get("weight")).transpose(2, 3, 4, 1, 0))
    if "bias" in s:
        asg.put("params", path + ("bias",), to_np(s.get("bias")))


def convert_bm2cp_up(ts: TorchState, asg: Assigner, base: tuple):
    """sensor_blocks.Up (single conv-bn): conv.0 / conv.1."""
    convert_conv(ts, asg, base + ("conv0",), scope="conv.0")
    convert_bn(ts, asg, base + ("bn0",), scope="conv.1")


def convert_img_cam_encode(ts: TorchState, asg: Assigner, base: tuple, *,
                           downsample: int):
    """sensor_blocks.ImgCamEncode (:68-212)."""
    convert_efficientnet_features(ts.sub("trunk"), asg, base + ("trunk",))
    convert_bm2cp_up(ts.sub("up1"), asg, base + ("up1",))
    if int(downsample) == 8:
        convert_bm2cp_up(ts.sub("up2"), asg, base + ("up2",))
    convert_conv(ts, asg, base + ("image_head",), scope="image_head")
    if "depth_head.weight" in ts:
        convert_conv(ts, asg, base + ("depth_head",), scope="depth_head")


def convert_point_pillar_bm2cp(sd: dict, variables: dict,
                               hypes: dict) -> Assigner:
    """PointPillarBM2CP (models/point_pillar_bm2cp.py) -> flax twin."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    pc = args["pc_params"]
    pre = args.get("preprocess") or {}
    nf = pc["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    img = args["img_params"]
    convert_img_cam_encode(ts.sub("camencode"), asg, ("camencode",),
                           downsample=img["img_downsample"])
    # MultiModalFusion: gated 3d convs + ImgModalFusion projection
    convert_conv3d(ts, asg, ("fusion", "multigate"), scope="fusion.multigate")
    convert_conv3d(ts, asg, ("fusion", "multifuse"), scope="fusion.multifuse")
    convert_linear(ts, asg, ("fusion", "img_proj"),
                   scope="fusion.img_fusion.proj")

    bb = args["modality_fusion"]["bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"), asg, ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
        layer_base=1,  # bm2cp uses common_modules/resblock (layer1-indexed)
    )
    shrink = args["modality_fusion"].get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    convert_det_heads(ts, asg, base=())
    _consume_scope(ts, "fusion_net")  # AttenComm is parameter-less
    asg.torch_leftovers = ts.leftovers()
    return asg


def _convert_multi_modal_fusion(ts: TorchState, asg: Assigner, scope: str,
                                base: tuple):
    """sensor_blocks.MultiModalFusion (:241-315): gated 3d convs +
    ImgModalFusion channel-attention projection."""
    convert_conv3d(ts, asg, base + ("multigate",), scope=f"{scope}.multigate")
    convert_conv3d(ts, asg, base + ("multifuse",), scope=f"{scope}.multifuse")
    convert_linear(ts, asg, base + ("img_proj",),
                   scope=f"{scope}.img_fusion.proj")


def convert_airv2x_bm2cp(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Airv2xBM2CP (models/airv2x_bm2cp.py) -> faithful flax twin
    (models/bm2cp_model.py): per-type LidarCamBM2CPEncoder (veh/rsu:
    PillarVFE + ImgCamEncode + MultiModalFusion) and drone
    LiftSplatShootEncoder (LSS CamEncode + BevEncode + MultiModalFusion
    against the zero mock-lidar volume), bm2cp ResNetBEVBackbone, shrink,
    optional compressor, det/seg heads; AttenComm is parameter-less."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    collab = list(args.get("collaborators", ()))
    for t, tname in (("vehicle", "veh_model"), ("rsu", "rsu_model")):
        if t not in collab:
            continue
        pc = args[t]["pc_params"]
        nf = pc["pillar_vfe"]["num_filters"]
        convert_pillar_vfe(ts.sub(f"{tname}.pillar_vfe"), asg,
                           (tname, "vfe"), fast=False, num_layers=len(nf))
        img = args[t]["img_params"]
        convert_img_cam_encode(ts.sub(f"{tname}.camencode"), asg,
                               (tname, "camencode"),
                               downsample=img["img_downsample"])
        _convert_multi_modal_fusion(ts, asg, f"{tname}.intra_fusion",
                                    (tname, "intra_fusion"))
    if "drone" in collab:
        convert_lss_encoder(ts.sub("drone_model"), asg,
                            ("drone_model", "lss"), args["drone"])
        _convert_multi_modal_fusion(ts, asg, "drone_model.intra_fusion",
                                    ("drone_model", "intra_fusion"))

    mod = args["modality_fusion"]
    bb = mod["bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"), asg, ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
        layer_base=1,  # bm2cp_modules backbone uses common_modules/resblock
    )
    shrink = mod.get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    if int(mod.get("compression", 0) or 0) > 0:
        convert_naive_compressor(ts.sub("naive_compressor"), asg,
                                 ("compressor",))
    if args.get("task", "det") == "det":
        convert_det_heads(ts, asg)
    else:
        convert_seg_head(ts, asg)
    _consume_scope(ts, "fusion_net")  # AttenComm is parameter-less
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_point_pillar_attresnet(sd: dict, variables: dict,
                                   hypes: dict) -> Assigner:
    """PointPillarIntermediateResNetDCN (point_pillar_attresnet.py) ->
    PointPillarAttResNet: coalign-style trunk, but ResNetModified names its
    layers 1-based (attresnet_modules/resblock.py ``layer{i+1}``); the
    ego-warp AttFusion is parameter-less."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)
    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    bb = args["base_bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"), asg, ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
        layer_base=1,
    )
    convert_det_heads(ts, asg, base=())
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_point_pillar_coalign(sd: dict, variables: dict,
                                 hypes: dict) -> Assigner:
    """PointPillarCoAlign (models/point_pillar_coalign.py) -> faithful flax
    twin: pillar vfe + res_bev_backbone + (optional) compressor + heads;
    Att_w_Warp fusion is parameter-less."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    bb = args.get("res_bev_backbone") or args["base_bev_backbone"]
    convert_resnet_backbone(
        ts.sub("backbone"), asg, ("backbone",),
        layer_nums=bb["layer_nums"],
        upsample_strides=bb.get("upsample_strides", ()),
    )
    if int(args.get("compression", 0)) > 0:
        convert_naive_compressor(ts.sub("naive_compressor"), asg,
                                 ("compressor",))
    shrink = args.get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    convert_det_heads(ts, asg, base=())
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_point_pillar_scope(sd: dict, variables: dict,
                               hypes: dict) -> Assigner:
    """PointPillarScope (models/point_pillar_scope.py) -> faithful flax
    twin (models/scope_model.py). The reference constructs a second
    pillar_vfe_2/scatter_2/backbone_2 it never calls — consumed."""
    args = dict(hypes["model"]["args"])
    args.setdefault("preprocess", hypes.get("preprocess"))
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)

    pre = args.get("preprocess") or {}
    nf = args["pillar_vfe"]["num_filters"]
    fast = bool((pre.get("args") or {}).get("fast_pillars", True)) and len(nf) == 1
    convert_pillar_vfe(ts.sub("pillar_vfe"), asg, ("vfe",), fast=fast,
                       num_layers=len(nf))
    bb = args["base_bev_backbone"]
    if "resnet" in bb:
        convert_resnet_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    else:
        convert_bev_backbone(
            ts.sub("backbone"), asg, ("backbone",),
            layer_nums=bb["layer_nums"],
            upsample_strides=bb.get("upsample_strides", ()),
        )
    for dead in ("pillar_vfe_2", "scatter_2", "backbone_2"):
        _consume_scope(ts, dead)
    shrink = args.get("shrink_header", {})
    if shrink.get("use", bool(shrink.get("dim"))):
        convert_downsample_conv(ts.sub("shrink_conv"), asg, ("shrink_conv",),
                                n_layers=len(shrink["dim"]))
    convert_det_heads(ts, asg, base=())

    fa = args["fusion_args"]
    fn = ts.sub("fusion_net")
    _consume_scope(fn, "naive_communication")
    if str((fa.get("agg_operator") or {}).get("mode")) == "Deform":
        for i in range(len(fa["num_filters"])):
            convert_deform_encoder(fn.sub(f"fuse_modules.{i}"), asg,
                                   (f"deform_fuse_{i}",))

    tfu = ts.sub("temporal_fusion")
    convert_conv(tfu, asg, ("temporal_fusion", "mtf_attention", "conv1"),
                 scope="mtf_attention.conv1")
    convert_sync_lstm(tfu.sub("sync_lstm"), asg,
                      ("temporal_fusion", "sync_lstm"))
    _consume_scope(ts, "late_fusion")
    asg.torch_leftovers = ts.leftovers()
    return asg


def convert_rtnh(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """RTNH_intermediate (models/RTNH_intermediate.py:9-56): pre_processor
    simplified_pointnet, the RadarSparseBackbone spconv/BN/deconv stack
    (RTNH_modules/rdr_sp_pw.py:46-172 — AttFusion is param-free), and the
    RdrSpcubeHead 1x1 heads (rdr_spcube_head.py:368-376)."""
    ts = TorchState(strip_module_prefix(sd))
    asg = Assigner(variables)
    convert_linear(
        ts.sub("pre_processor"), asg, ("simplified_pointnet",),
        scope="simplified_pointnet",
    )
    bb = ts.sub("backbone")
    args = hypes["model"]["args"]
    enc_ch = list(
        (args.get("BACKBONE") or {}).get("ENCODING", {}).get(
            "CHANNEL", [64, 128, 256]
        )
    )

    def sconv(scope, name):
        convert_conv(bb.sub(scope), asg, ("backbone", name, "Conv_0"))

    def sbn(scope, name):
        convert_bn(
            bb.sub(scope), asg, ("backbone", name, "MaskedBatchNorm_0")
        )

    sconv("input_conv", "input_conv")
    for i in range(len(enc_ch)):
        sconv(f"spconv{i}", f"spconv{i}")
        sbn(f"bn{i}", f"bn{i}")
        sconv(f"subm{i}a", f"subm{i}a")
        sbn(f"bn{i}a", f"bn{i}a")
        sconv(f"subm{i}b", f"subm{i}b")
        sbn(f"bn{i}b", f"bn{i}b")
        sconv(f"toBEV{i}", f"toBEV{i}")
        sbn(f"bnBEV{i}", f"bnBEV{i}")
        convert_deconv(
            bb.sub(f"convtrans2d{i}"), asg,
            ("backbone", f"convtrans2d{i}", "Conv_0"),
        )
        convert_bn(bb.sub(f"bnt{i}"), asg, ("backbone", f"bnt{i}"))
    convert_conv(ts.sub("head"), asg, ("conv_cls",), scope="conv_cls")
    convert_conv(ts.sub("head"), asg, ("conv_reg",), scope="conv_reg")
    asg.torch_leftovers = ts.leftovers()
    return asg


CONVERTERS: dict[str, Callable[[dict, dict, dict], Assigner]] = {
    "RTNH_intermediate": convert_rtnh,
    "rtnh_intermediate": convert_rtnh,
    "airv2x_where2comm": convert_airv2x_where2comm,
    "airv2x_where2com": convert_airv2x_where2comm,
    "airv2x_when2com": convert_airv2x_when2com,
    "airv2x_cobevt": convert_airv2x_cobevt,
    "airv2x_v2xvit": convert_airv2x_v2xvit,
    "airv2x_v2vnet": convert_airv2x_v2vnet,
    "airv2x_heal": convert_airv2x_heal,
    "airv2x_stamp": convert_airv2x_stamp,
    "airv2x_sicp": convert_airv2x_sicp,
    "point_pillar_intermediate": convert_point_pillar_intermediate,
    "point_pillar": convert_point_pillar_intermediate,
    "point_pillar_attfusion": convert_point_pillar_intermediate,
    "point_pillar_early": convert_point_pillar_intermediate,
    "point_pillar_max": convert_point_pillar_intermediate,
    "point_pillar_fcooper": convert_point_pillar_intermediate,
    "point_pillar_spatialcooper": _flat_converter(_flat_spatialcooper_fusion),
    "point_pillar_spatialcooper_lrf": _flat_converter(
        _flat_spatialcooper_fusion
    ),
    "point_pillar_adafusion": _flat_converter(_flat_spatialcooper_fusion),
    "point_pillar_baseline_multiscale": convert_point_pillar_intermediate,
    "point_pillar_where2comm": convert_point_pillar_intermediate,
    "point_pillar_where2comm_lrf": convert_point_pillar_intermediate,
    "point_pillar_coalign": convert_point_pillar_coalign,
    "point_pillar_coalign_lrf": convert_point_pillar_coalign,
    "point_pillar_attresnet": convert_point_pillar_attresnet,
    "PFA_net": convert_point_pillar_intermediate,
    "pfanet": convert_point_pillar_intermediate,
    "point_pillar_disconet": convert_point_pillar_intermediate,
    "point_pillar_disconet_teacher": convert_point_pillar_intermediate,
    "point_pillar_intermediate_lrf": convert_point_pillar_intermediate,
    "point_pillar_l4dr": convert_point_pillar_l4dr,
    "point_pillar_L4DR": convert_point_pillar_l4dr,
    "point_pillar_interf": convert_point_pillar_interf,
    "point_pillar_InterF": convert_point_pillar_interf,
    "point_pillar_intermediate_lrf_MDD": _flat_converter(_flat_mdd_fusion),
    "point_pillar_mdd": _flat_converter(_flat_mdd_fusion),
    "point_pillar_v2xvit": convert_point_pillar_v2xvit,
    "point_pillar_v2xvit_lrf": convert_point_pillar_v2xvit,
    "point_pillar_cobevt": convert_point_pillar_cobevt,
    "point_pillar_cobevt_lrf": convert_point_pillar_cobevt,
    "point_pillar_v2vnet": convert_point_pillar_v2vnet,
    "point_pillar_when2com": convert_point_pillar_when2com,
    "point_pillar_sicp": convert_point_pillar_sicp,
    "point_pillar_sicp_lrf": convert_point_pillar_sicp,
    "point_pillar_how2comm": convert_point_pillar_how2comm,
    "point_pillar_scope": convert_point_pillar_scope,
    "point_pillar_where2comm_bm2cp": convert_point_pillar_where2comm_bm2cp,
    "point_pillar_bm2cp": convert_point_pillar_bm2cp,
    "airv2x_bm2cp": convert_airv2x_bm2cp,
    "airv2x_early": convert_point_pillar_intermediate,
}


def convert_state_dict(sd: dict, variables: dict, hypes: dict) -> Assigner:
    """Dispatch on ``hypes['model']['core_method']``; returns the Assigner
    whose ``.variables`` is the converted flax tree and whose ``assigned`` /
    ``skipped`` lists describe the mapping."""
    name = hypes["model"]["core_method"]
    if name not in CONVERTERS:
        raise KeyError(
            f"no torch converter for model '{name}' (have: {sorted(CONVERTERS)})"
        )
    if "model_state_dict" in sd:  # reference checkpoint wrapper dicts
        sd = sd["model_state_dict"]
    elif "state_dict" in sd:
        sd = sd["state_dict"]
    asg = CONVERTERS[name](sd, variables, hypes)
    for msg in asg.skipped:
        log.warning("checkpoint convert: skipped %s", msg)
    return asg


def read_checkpoint(path: str) -> dict:
    """A reference ``.pth``'s state dict (a pickled module gives its own)."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd if isinstance(sd, dict) else sd.state_dict()


def load_reference_checkpoint(model, sd: dict, hypes: dict) -> Assigner:
    """Convert the reference state dict ``sd`` onto the port's ``model`` in
    place: the map runs into ``flax_variables(model)``, whose leaves it does
    not assign keep the model's own values, and the result loads through
    the weight bridge onto the model's device. Returns the Assigner
    (``assigned``, ``skipped``, ``torch_leftovers``)."""
    from airv2x_tpu_torch.utils.weights import flax_variables, load_flax_variables

    asg = convert_state_dict(sd, flax_variables(model), hypes)
    load_flax_variables(model, asg.variables)
    return asg
