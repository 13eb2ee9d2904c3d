"""How2comm's collaboration parts (counterpart of
airv2x_tpu/models/fusion/how2comm.py), channels-last (..., H, W, C) on
dense agent slots with an ``agent_mask``, ego first.

  * ``gaussian_kernel_2d`` / ``gaussian_kernel_1d`` and the two smoothings:
    the 2-D kernel is Where2comm's (the reference's 1 / (2 pi sigma), no
    renormalisation), the 1-D one is normalised;
  * ``flow_warp_border``: a per-pixel (x, y) offset field applied as
    ``grid_sample(align_corners=False, padding_mode='border')``;
  * ``ReduceInfTC`` (the DFF flow head: a stride-2 conv pyramid down and
    back through ``nn.ConvTranspose2d``, which the JAX package's
    ``TorchConvTranspose`` mimics, to a 2-channel offset and a scale),
    ``FlowBackbone`` (torchvision BasicBlock stages, their deblocks and the
    extra 2x ``// 6`` deblock) and ``FlowGenerator``: each collaborator's
    current map estimated from [history, current] by the predicted flow,
    with the offset loss (cosine similarity against 1, a masked mean);
  * ``MutualCommunication``: the ego's channel and spatial requests against
    each collaborator's attentions, gaussian-smoothed and gated by the
    collaborator's activation into a per-pixel per-channel sparse mask, the
    comm rate and the DeepInfoMax loss (``commu_loss``; the marginal pairing
    rolls the slot axis);
  * ``confidence_maps``: the smoothed max-sigmoid of single-agent logits.

Convolutions run on the NCHW view and cast their input to their weight's
dtype (the compute dtype after ``cast_weights_``); BatchNorms are the
torchvision ones (eps 1e-5, flax momentum 0.9) but for the flow backbone's
deblocks (the backbone's 1e-3 / 0.99). Flax scope names are the attribute
names.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from airv2x_tpu_torch.models.camera.trunks import TorchBasicBlock, torch_bn
from airv2x_tpu_torch.models.fusion.scope import smoothed_confidence
from airv2x_tpu_torch.models.fusion.where2comm import (
    _gaussian_kernel as gaussian_kernel_2d, gaussian_smooth)  # noqa: F401
from airv2x_tpu_torch.models.nn import BatchNorm2d
from airv2x_tpu_torch.ops.warp import device_scalar, grid_sample_bilinear


def gaussian_kernel_1d(k_size: int, sigma: float) -> np.ndarray:
    x = np.arange(-(k_size - 1) // 2, (k_size + 1) // 2, dtype=np.float32)
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _kernel_1d(k_size: int, sigma: float, device, dtype):
    # a normal tensor even when first made under inference mode: training
    # may save it for a backward
    with torch.inference_mode(False):
        return torch.from_numpy(gaussian_kernel_1d(k_size, sigma)).to(
            device=device, dtype=dtype)


def gaussian_smooth_2d(x, k_size: int, sigma: float):
    """SAME-padded blur of (..., H, W, 1) by the 2-D kernel, in x's dtype."""
    return gaussian_smooth(x[..., 0], k_size, sigma)[..., None]


def gaussian_smooth_channels(v, k_size: int, sigma: float):
    """SAME-padded blur of (..., C) along C by the 1-D kernel."""
    kern = _kernel_1d(k_size, float(sigma), v.device, v.dtype)
    out = F.conv1d(v.reshape(-1, 1, v.shape[-1]), kern[None, None],
                   padding=(k_size - 1) // 2)
    return out.reshape(v.shape)


def conv_cl(conv, x):
    """``conv`` (a Conv2d or ConvTranspose2d) on channels-last (N, H, W, C)
    x, its input cast to its weight's dtype -> (N, H', W', C')."""
    y = conv(x.permute(0, 3, 1, 2).to(conv.weight.dtype))
    return y.permute(0, 2, 3, 1)


def flow_warp_border(feats, flow):
    """Warp (..., H, W, C) by the per-pixel (..., H, W, 2) (x, y) offsets:
    the normalised grid of ``grid_sample(align_corners=False)`` clamped to
    the border pixels, then bilinear."""
    h, w = feats.shape[-3], feats.shape[-2]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=feats.device),
        torch.arange(w, dtype=torch.float32, device=feats.device),
        indexing="ij")
    fl = flow.float()
    gx = (fl[..., 0] + xs) / device_scalar((w - 1) / 2.0, fl) - 1.0
    gy = (fl[..., 1] + ys) / device_scalar((h - 1) / 2.0, fl) - 1.0
    px = (((gx + 1.0) * w - 1.0) * 0.5).clamp(0.0, w - 1)
    py = (((gy + 1.0) * h - 1.0) * 0.5).clamp(0.0, h - 1)
    lead = feats.shape[:-3]
    out = grid_sample_bilinear(feats.reshape((-1, h, w, feats.shape[-1])),
                               px.reshape(-1, h, w), py.reshape(-1, h, w))
    return out.reshape(lead + (h, w, feats.shape[-1]))


class ReduceInfTC(nn.Module):
    """The DFF flow head on (N, H, W, in_c): three stride-2 convs down to
    ``channel // 64`` channels, three transposed convs back to ``channel //
    2``, each with BN and ReLU -> (offset (N, H, W, 2), scale + 1 (N, H, W,
    1))."""

    def __init__(self, in_c: int, channel: int = 128):
        super().__init__()
        c = channel
        self.conv1_2 = nn.Conv2d(in_c, c // 4, 3, stride=2)
        self.bn1_2 = torch_bn(c // 4)
        self.conv1_3 = nn.Conv2d(c // 4, c // 8, 3, stride=2)
        self.bn1_3 = torch_bn(c // 8)
        self.conv1_4 = nn.Conv2d(c // 8, max(1, c // 64), 3, stride=2, padding=1)
        self.bn1_4 = torch_bn(max(1, c // 64))
        self.deconv2_1 = nn.ConvTranspose2d(max(1, c // 64), c // 8, 3, 2, 1)
        self.bn2_1 = torch_bn(c // 8)
        self.deconv2_2 = nn.ConvTranspose2d(c // 8, c // 4, 3, 2)
        self.bn2_2 = torch_bn(c // 4)
        self.deconv2_3 = nn.ConvTranspose2d(c // 4, c // 2, 3, 2, output_padding=1)
        self.bn2_3 = torch_bn(c // 2)
        self.conv_flow = nn.Conv2d(c // 2, 2, 3, padding=1)
        self.conv_scale = nn.Conv2d(c // 2, 1, 1, bias=False)

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        for name in ("1_2", "1_3", "1_4", "2_1", "2_2", "2_3"):
            conv = getattr(self, ("conv" if name[0] == "1" else "deconv") + name)
            y = torch.relu(getattr(self, "bn" + name)(conv(y.to(conv.weight.dtype))))
        y = y.to(self.conv_flow.weight.dtype)
        offset = self.conv_flow(y).permute(0, 2, 3, 1)
        scale = self.conv_scale(y).permute(0, 2, 3, 1)
        return offset, scale + 1.0


class FlowBackbone(nn.Module):
    """torchvision BasicBlock stages (``layer<i>_<j>``), a bias-free
    transposed-conv deblock per stage (``deblock<i>_deconv`` / ``_bn``),
    the ups concatenated, then ``final_deconv`` (2x, to ``sum // 6``
    channels) and ``final_bn``: (N, C, H, W) -> (N, sum // 6, H', W')."""

    def __init__(self, in_c: int, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters):
        super().__init__()
        self.layers = []
        c = in_c
        for li, (n, s, f) in enumerate(zip(layer_nums, layer_strides,
                                           num_filters)):
            names = []
            for bi in range(n):
                stride = s if bi == 0 else 1
                ds = bi == 0 and (stride != 1 or c != f)
                self.add_module(f"layer{li}_{bi}",
                                TorchBasicBlock(c, f, stride, downsample=ds))
                names.append(f"layer{li}_{bi}")
                c = f
            self.layers.append(names)
        for i, (f, s) in enumerate(zip(num_upsample_filters, upsample_strides)):
            self.add_module(f"deblock{i}_deconv", nn.ConvTranspose2d(
                num_filters[i], f, s, s, bias=False))
            self.add_module(f"deblock{i}_bn", BatchNorm2d(f))
        c_in = sum(num_upsample_filters)
        self.final_deconv = nn.ConvTranspose2d(c_in, c_in // 6, 2, 2, bias=False)
        self.final_bn = BatchNorm2d(c_in // 6)
        self.out_channels = c_in // 6

    def forward(self, x):
        feats = []
        for names in self.layers:
            for name in names:
                block = self.get_submodule(name)
                x = block(x.to(block.conv1.weight.dtype))
            feats.append(x)
        ups = []
        for i, f in enumerate(feats):
            deconv = self.get_submodule(f"deblock{i}_deconv")
            ups.append(torch.relu(self.get_submodule(f"deblock{i}_bn")(
                deconv(f.to(deconv.weight.dtype)))))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return torch.relu(self.final_bn(self.final_deconv(x)))


class FlowGenerator(nn.Module):
    """Each collaborator's current map estimated from its delayed one: the
    [history, current] pair through ``backbone`` and ``pre_encoder`` gives
    a flow offset and scale, the history is warped by it and scaled. The
    ego slot keeps its true current map; absent slots are zero."""

    def __init__(self, backbone_cfg: dict, channel: int = 64):
        super().__init__()
        bb = backbone_cfg
        self.backbone = FlowBackbone(
            2 * channel, bb["layer_nums"], bb["layer_strides"],
            bb["num_filters"], bb["upsample_strides"], bb["num_upsample_filter"])
        self.pre_encoder = ReduceInfTC(self.backbone.out_channels, 2 * channel)

    def forward(self, cur, hist, agent_mask):
        """cur / hist (B, L, H, W, C); agent_mask (B, L) -> (estimated
        current maps (B, L, H, W, C), the offset loss)."""
        b, l, h, w, c = cur.shape
        n = b * (l - 1)
        colla = torch.cat([hist[:, 1:], cur[:, 1:]], dim=-1).reshape(n, h, w, 2 * c)
        fused = self.backbone(colla.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        offset, scale = self.pre_encoder(fused)
        src = hist[:, 1:].reshape(n, h, w, c)
        tgt = cur[:, 1:].reshape(n, h, w, c)
        est = flow_warp_border(src, offset) * scale
        dot = (est * tgt).sum((1, 2, 3))
        nrm = (torch.linalg.norm(est.reshape(n, -1), dim=1)
               * torch.linalg.norm(tgt.reshape(n, -1), dim=1))
        sim = dot / nrm.clamp_min(1e-8)
        nmask = agent_mask[:, 1:].reshape(-1).to(sim.dtype)
        per_sample = ((sim - 1.0) ** 2 * nmask).reshape(b, l - 1)
        cnt = agent_mask[:, 1:].sum(1).to(sim.dtype).clamp_min(1.0)
        offset_loss = (per_sample.sum(1) / cnt).sum()
        est = est.reshape(b, l - 1, h, w, c) * agent_mask[
            :, 1:, None, None, None].to(est.dtype)
        return torch.cat([cur[:, :1].to(est.dtype), est], dim=1), offset_loss


class MutualCommunication(nn.Module):
    """The ego's requests against the collaborators' attentions -> (sparse
    slot maps, DeepInfoMax loss, mean comm rate of the present
    collaborators, per-slot masks (B, L, H, W, C), the ego's all ones)."""

    def __init__(self, in_planes: int, thre: float, request_flag: bool = True,
                 k_size: int = 5, c_sigma: float = 1.0, ratio: int = 16):
        super().__init__()
        self.thre, self.request_flag = thre, request_flag
        self.k_size, self.c_sigma = k_size, c_sigma
        c = in_planes
        self.ch_mlp_0 = nn.Conv2d(c, c // ratio, 1, bias=False)
        self.ch_mlp_1 = nn.Conv2d(c // ratio, c, 1, bias=False)
        self.spatial_request = nn.Conv2d(2, 1, 3, padding=1, bias=False)
        if request_flag:
            self.channel_fusion = nn.Conv2d(2 * c, c, 1, bias=False)
            self.spatial_fusion = nn.Conv2d(2, 1, 1, bias=False)
        self.stat_conv1 = nn.Conv2d(2 * c, 4 * c, 1)
        self.stat_conv2 = nn.Conv2d(4 * c, 4 * c, 1)
        self.stat_conv3 = nn.Conv2d(4 * c, 1, 1)

    def _stat_net(self, v):
        y = torch.relu(conv_cl(self.stat_conv1, v))
        return conv_cl(self.stat_conv3, torch.relu(conv_cl(self.stat_conv2, y)))

    def forward(self, feats, agent_mask):
        b, l, h, w, c = feats.shape
        ks, sig = self.k_size, self.c_sigma
        flat = feats.reshape(b * l, h, w, c)

        def shared_mlp(v):
            return conv_cl(self.ch_mlp_1, torch.relu(conv_cl(self.ch_mlp_0, v)))

        avg = flat.mean((1, 2), keepdim=True)
        mx = flat.amax((1, 2), keepdim=True)
        ch_att = torch.sigmoid(shared_mlp(avg) + shared_mlp(mx)).reshape(
            b, l, 1, 1, c)
        sp_in = torch.cat([flat.mean(-1, keepdim=True),
                           flat.amax(-1, keepdim=True)], dim=-1)
        sp_att = torch.sigmoid(conv_cl(self.spatial_request, sp_in)).reshape(
            b, l, h, w, 1)
        activation = gaussian_smooth_2d(
            torch.sigmoid(feats.mean(-1, keepdim=True)), ks, sig)
        if self.request_flag:
            ch_in = torch.cat([(1.0 - ch_att[:, :1]).expand_as(ch_att[:, 1:]),
                               ch_att[:, 1:]], dim=-1)
            ch_coeff = conv_cl(self.channel_fusion, ch_in.reshape(
                b * (l - 1), 1, 1, 2 * c)).reshape(b, l - 1, 1, 1, c)
            sp_in2 = torch.cat([(1.0 - sp_att[:, :1]).expand_as(sp_att[:, 1:]),
                                sp_att[:, 1:]], dim=-1)
            sp_coeff = conv_cl(self.spatial_fusion, sp_in2.reshape(
                b * (l - 1), h, w, 2)).reshape(b, l - 1, h, w, 1)
        else:
            ch_coeff, sp_coeff = ch_att[:, 1:], sp_att[:, 1:]
        ch_coeff = gaussian_smooth_channels(torch.sigmoid(ch_coeff), ks, sig)
        sp_coeff = gaussian_smooth_2d(torch.sigmoid(sp_coeff), ks, sig)
        sparse_mask = ((ch_coeff * sp_coeff * activation[:, 1:]) > self.thre
                       ).to(feats.dtype)

        nmask = agent_mask[:, 1:].to(feats.dtype)
        rates = sparse_mask.mean((2, 3, 4)) * nmask
        comm_rate = rates.sum() / nmask.sum().clamp_min(1.0)
        sparse = torch.cat([feats[:, :1], feats[:, 1:] * sparse_mask], dim=1)
        masks = torch.cat([torch.ones_like(feats[:, :1]),
                           sparse_mask.expand_as(feats[:, 1:])], dim=1)

        org = feats.reshape(b * l, h, w, c)
        sp = sparse.reshape(b * l, h, w, c)
        prime = torch.roll(feats, -1, dims=1).reshape(b * l, h, w, c)
        t_joint = self._stat_net(torch.cat([org, sp], dim=-1))
        t_prime = self._stat_net(torch.cat([prime, sp], dim=-1))
        wmask = agent_mask.reshape(b * l, 1, 1, 1).to(feats.dtype)
        denom = (wmask.sum() * h * w).clamp_min(1.0)
        joint = (-F.softplus(-t_joint) * wmask).sum() / denom
        marginal = (F.softplus(t_prime) * wmask).sum() / denom
        multi = (agent_mask.sum(1) > 1).any().to(feats.dtype)
        commu_loss = -(joint - marginal) * multi
        return sparse, commu_loss, comm_rate, masks


def confidence_maps(psm, k_size: int = 5, c_sigma: float = 1.0):
    """(B, L, H, W, A) logits -> (B, L, H, W, 1): SCOPE's smoothed max-sigmoid
    over the anchors."""
    return smoothed_confidence(psm.movedim(-1, -3), k_size, c_sigma)[..., None]
