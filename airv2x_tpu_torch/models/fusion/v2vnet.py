"""V2VNet fusion (counterpart of airv2x_tpu/models/fusion/v2vnet.py):
message passing over the agents' BEV maps. Each round warps every sender
into every receiver's frame by ``pairwise_t_full``, runs the shared message
conv on [warped sender, receiver], masks the messages by the warp's ROI and
the agent mask, aggregates them (masked mean or max over the senders) and
updates every receiver from the previous round's maps (Jacobi style): by a
ConvGRU from a zero hidden state on [receiver, aggregate], or by adding the
aggregate. The ego slot's map then goes through a Linear.

The JAX package loops over the receivers; here every (receiver, sender)
pair runs in one warp and one conv, the same arithmetic. The maps stay
channels-last (B, L, H, W, C) between the convs, as the warp samples them;
each conv computes in its weight's dtype on the NCHW view. The warp samples
on an f32 grid, so under a bf16 compute dtype [warped, receiver] is f32 in
JAX and the conv casts it down: casting each part first gives the same
input.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.v2xvit import _dense
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A flax ``nn.Conv`` on a channels-last map: the torch conv in its
    weight's dtype on the NCHW view (channels_last memory), back to NHWC."""
    x = x.to(conv.weight.dtype).permute(0, 3, 1, 2)
    return conv(x).permute(0, 2, 3, 1)


class ConvGRUCell(nn.Module):
    """Convolutional GRU cell on channels-last maps: reset and update gates
    from one conv of [x, h], the candidate from one conv of [x, reset h]."""

    FLAX_NAMES = {"conv_gates": "Conv_0", "conv_can": "Conv_1"}

    def __init__(self, input_dim: int, hidden_dim: int, kernel_size):
        super().__init__()
        k = tuple(kernel_size)
        self.conv_gates = nn.Conv2d(input_dim + hidden_dim, 2 * hidden_dim, k,
                                    padding="same")
        self.conv_can = nn.Conv2d(input_dim + hidden_dim, hidden_dim, k,
                                  padding="same")

    def forward(self, x, h):
        """x (N, H, W, Cin), h (N, H, W, C) -> the next h."""
        gates = torch.sigmoid(conv_nhwc(self.conv_gates, torch.cat([x, h], -1)))
        reset, update = gates.chunk(2, dim=-1)
        cand = torch.tanh(conv_nhwc(self.conv_can, torch.cat([x, reset * h], -1)))
        return (1.0 - update) * h + update * cand


class V2VNetFusion(nn.Module):
    """The ``v2vfusion`` config block: (B, L, C, H, W) -> (B, C, H, W)."""

    FLAX_NAMES = {"msg_cnn": "Conv_0", "gru": "ConvGRUCell_0", "out": "Dense_0"}

    def __init__(self, args: dict, channels: int):
        super().__init__()
        c = int(channels)
        self.num_iter = int(args["num_iteration"])
        self.agg = args.get("agg_operator", "avg")
        self.discrete_ratio = float(args["voxel_size"][0])
        self.downsample_rate = float(args["downsample_rate"])
        self.msg_cnn = nn.Conv2d(2 * c, c, 3, padding=1)
        self.gru = None
        if bool(args.get("gru_flag", True)):
            # reference configs give a per-layer list: kernel_size: [[3, 3]]
            ks = args["conv_gru"]["kernel_size"]
            if isinstance(ks[0], (list, tuple)):
                ks = ks[0]
            self.gru = ConvGRUCell(2 * c, c, ks)
        self.out = nn.Linear(c, c)

    def forward(self, x, agent_mask, pairwise_t_full):
        """x (B, L, C, H, W); agent_mask (B, L) bool; pairwise_t_full (B, L,
        L, 4, 4), [i, j] the transform from agent j into agent i's frame."""
        b, l, c, h, w = x.shape
        dev = x.device
        aff = normalized_pairwise_affine(
            pairwise_t_full, h, w, self.discrete_ratio, self.downsample_rate)
        aff = aff.reshape(b * l * l, 2, 3)  # (receiver i, sender j) pairs
        senders = (torch.arange(b, device=dev)[:, None, None] * l
                   + torch.arange(l, device=dev)[None, None, :]).expand(
                       b, l, l).reshape(-1)
        ones = torch.ones((1, h, w, 1), dtype=torch.float32, device=dev)
        roi = warp_affine_normalized(
            ones, aff, torch.zeros_like(senders)) > 0.5
        roi = roi.reshape(b, l, l, h, w, 1).to(x.dtype)
        am = agent_mask[:, None, :, None, None, None].to(x.dtype)  # senders

        feats = x.permute(0, 1, 3, 4, 2)
        for _ in range(self.num_iter):
            warped = warp_affine_normalized(
                feats.reshape(b * l, h, w, c), aff, senders)
            dt = self.msg_cnn.weight.dtype
            rep = feats[:, :, None].expand(b, l, l, h, w, c)
            msg_in = torch.cat([warped.to(dt), rep.reshape(-1, h, w, c).to(dt)],
                               dim=-1)
            msg = conv_nhwc(self.msg_cnn, msg_in).reshape(b, l, l, h, w, c)
            msg = msg * roi * am
            if self.agg == "max":
                neg = torch.full((), -1e9, dtype=msg.dtype, device=dev)
                agg = torch.where(am > 0, msg, neg).amax(dim=2)
                agg = torch.where(agg <= -1e8, torch.zeros_like(agg), agg)
            else:  # the mean over the present senders
                agg = msg.sum(dim=2) / am.sum(dim=2).clamp_min(1.0)
            if self.gru is not None:
                gru_in = torch.cat([feats, agg], dim=-1).reshape(b * l, h, w, 2 * c)
                hidden = torch.zeros((b * l, h, w, c), dtype=feats.dtype,
                                     device=dev)
                feats = self.gru(gru_in, hidden).reshape(b, l, h, w, c)
            else:
                feats = feats + agg
        return _dense(self.out, feats[:, 0]).permute(0, 3, 1, 2)
