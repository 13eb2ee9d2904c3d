"""K4, the 3x3 stride-1 SAME conv with a fused affine + ReLU epilogue:
kernel wrapper, its plain PyTorch version, the im2col form and the support
gates (counterpart of airv2x_tpu/ops/pallas_conv.py).

Layouts follow the JAX package: x NHWC, w HWIO, output NHWC in x's dtype.
The CUDA kernel is ``csrc/conv3x3.cu``; its note says what bounds it and
how it is laid out. ``allmaps=True`` (K4b) computes the same function with
every map in one block's loop instead of a grid over maps (K4a).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from airv2x_tpu_torch import kernels

# The gates keep the JAX package's estimate of the TPU kernel's VMEM use
# (pallas_conv.py:53-66, :128-144) against its 100 MiB budget, so both
# packages accept and refuse the same shapes. The budget is the TPU's; the
# CUDA kernel itself only needs channels that are multiples of 8.
_VMEM_BUDGET = 100 * 1024 * 1024


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _padded_w(w: int, dtype) -> int:
    t = 32 // _itemsize(dtype)  # the TPU's sublane tile: f32 8, bf16 16
    return -(-w // t) * t


def supports_conv3x3(shape, dtype, features: int) -> bool:
    """Whether the grid-over-maps kernel takes NHWC ``shape`` -> ``features``
    channels in ``dtype`` (the JAX ``supports_pallas_conv3x3``)."""
    if len(shape) != 4:
        return False
    _, h, w, c = shape
    if c % 8 or features % 8 or h < 2 or w < 2:
        return False
    item = _itemsize(dtype)
    wp = _padded_w(w, dtype)
    xblk = (h + 2) * wp * 3 * c * item
    oblk = h * wp * features * item
    acc = h * wp * features * 4
    est = 2 * xblk + 2 * oblk + acc + 3 * 3 * c * features * item
    return est <= _VMEM_BUDGET


def supports_conv3x3_allmaps(shape, dtype, features: int) -> bool:
    """The same gate for the all-maps form, which holds every map at once
    (the JAX ``supports_pallas_conv3x3_allmaps``)."""
    if len(shape) != 4:
        return False
    b, h, w, c = shape
    if c % 8 or features % 8 or h < 2 or w < 2:
        return False
    item = _itemsize(dtype)
    wp = _padded_w(w, dtype)
    est = (
        b * (h + 2) * wp * 3 * c * item
        + b * h * wp * features * item
        + h * wp * features * 4
        + 3 * 3 * c * features * item
    )
    return est <= _VMEM_BUDGET


def _epilogue(acc, scale, bias, relu: bool, dtype):
    """f32 ``acc * scale + bias``, ReLU, cast: the kernels' epilogue."""
    if scale is not None:
        acc = acc * scale.float()
    if bias is not None:
        acc = acc + bias.float()
    if relu:
        acc = torch.relu(acc)
    return acc.to(dtype)


def conv3x3_same_plain(x, w, scale=None, bias=None, *, relu: bool = False):
    """Plain PyTorch version of ``conv3x3_same``: the operands (w first cast
    to x's dtype) widened to f32, one 3x3 SAME conv, the f32 epilogue, a
    cast to x's dtype. On a card, a caller that wants full f32 turns TF32
    off for cuDNN."""
    wc = w.to(x.dtype)
    acc = F.conv2d(x.permute(0, 3, 1, 2).float(),
                   wc.permute(3, 2, 0, 1).float(), padding=1)
    return _epilogue(acc.permute(0, 2, 3, 1), scale, bias, relu, x.dtype)


def conv3x3_im2col(x, w, scale=None, bias=None, *, relu: bool = False):
    """The im2col form (pallas_conv.py:conv3x3_im2col, the XLA path there):
    (B*H*W, 9C) patches in (c, kh, kw) order times the (9C, Cout) weights,
    accumulated in f32 over x-dtype operands, then the same epilogue."""
    b, h, width, c = x.shape
    cout = w.shape[-1]
    patches = F.unfold(x.permute(0, 3, 1, 2), 3, padding=1)  # (B, 9C, HW)
    wf = w.to(x.dtype).permute(2, 0, 1, 3).reshape(9 * c, cout)
    acc = patches.transpose(1, 2).float() @ wf.float()  # (B, HW, Cout)
    return _epilogue(acc, scale, bias, relu, x.dtype).reshape(b, h, width, cout)


def _check(x, w, scale, bias):
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"conv3x3_same: x {tuple(x.shape)} must be NHWC and "
                         f"w {tuple(w.shape)} HWIO")
    kh, kw, cin, cout = w.shape
    if (kh, kw) != (3, 3) or cin != x.shape[-1]:
        raise ValueError(f"conv3x3_same: w {tuple(w.shape)} does not fit x "
                         f"{tuple(x.shape)}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and t.numel() != cout:
            raise ValueError(f"conv3x3_same: {name} has {t.numel()} entries, "
                             f"Cout is {cout}")
    for name, t in (("w", w), ("scale", scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"conv3x3_same: {name} is on {t.device}, x on "
                             f"{x.device}")


def _aligned(t):
    """``t`` contiguous at a 16-byte aligned address (the kernel's loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv3x3_same(x, w, scale=None, bias=None, *, relu: bool = False,
                 allmaps: bool = False):
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC, with an optional fused
    per-channel f32 affine and ReLU (a folded eval BatchNorm).

    Equals ``relu?(conv(x, w) * scale + bias)`` with f32 accumulation over
    x-dtype operands; the output has x's dtype (float32 or bfloat16).

    A CPU tensor runs the plain version (as the JAX package's interpret
    mode does off the TPU); a CUDA tensor launches the kernel, K4b when
    ``allmaps``, else K4a. The kernel needs C and Cout multiples of 8.
    """
    _check(x, w, scale, bias)
    if x.device.type == "cpu":
        return conv3x3_same_plain(x, w, scale, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_same: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"conv3x3_same: dtype {x.dtype} unsupported")
    b, h, width, c = x.shape
    cout = w.shape[-1]
    if c % 8 or cout % 8:
        raise ValueError(f"conv3x3_same: the kernel needs channels that are "
                         f"multiples of 8, got {c} -> {cout}")
    x = _aligned(x)
    wc = _aligned(w.to(x.dtype))
    f32 = dict(dtype=torch.float32, device=x.device)
    scale = (torch.ones(cout, **f32) if scale is None
             else scale.to(torch.float32).reshape(cout).contiguous())
    bias = (torch.zeros(cout, **f32) if bias is None
            else bias.to(torch.float32).reshape(cout).contiguous())
    out = torch.empty((b, h, width, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = kernels.lib("conv3x3").conv3x3(
            x.data_ptr(), wc.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, width, c, cout, int(relu), int(allmaps),
            int(x.dtype == torch.bfloat16), kernels.current_stream(),
        )
    kernels.check("conv3x3", err)
    kernels.LAUNCHES["conv3x3_allmaps" if allmaps else "conv3x3"] += 1
    return out
