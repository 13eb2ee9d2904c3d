"""When2com fusion (counterpart of airv2x_tpu/models/fusion/when2com.py): a
learned handshake. Every agent's map is warped into the ego frame; a policy
CNN (4x down, 256 channels) and two flatten-MLPs give each agent a key and
the ego a query; a softmax over the present agents of key . query (in
``mode: activated`` with the weights <= 0.2 zeroed) weighs the warped maps
into the fused ego map.

The MLPs flatten the policy map channels-last, (H/4, W/4, 256), as the flax
module does: their first Linear's inputs are in that order. The warp samples
on an f32 grid, so under a bf16 compute dtype the warped maps and the fused
map are f32, as in JAX; each conv and Linear computes in its weight's dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from airv2x_tpu_torch.models.fusion.common import NEG_INF
from airv2x_tpu_torch.models.fusion.v2xvit import _dense
from airv2x_tpu_torch.models.nn import BatchNorm2d
from airv2x_tpu_torch.ops.warp import (
    normalized_pairwise_affine, warp_affine_normalized)

# the policy CNN's blocks: (filters, stride), 3x3 convs with padding 1
POLICY_PLAN = ((512, 1), (256, 1), (256, 2), (256, 1), (256, 2))
ACTIVATION_THRESHOLD = 0.2  # ``mode: activated`` keeps weights above it


def policy_hw(h: int, w: int) -> tuple[int, int]:
    """The policy map's (H, W) for an (h, w) input."""
    for _, stride in POLICY_PLAN:
        h, w = (h - 1) // stride + 1, (w - 1) // stride + 1
    return h, w


class _ConvBNRelu(nn.Module):
    """3x3 conv (explicit padding 1, biased) -> BatchNorm (eps 1e-3) ->
    ReLU, NCHW."""

    FLAX_NAMES = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def __init__(self, in_ch: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, filters, 3, stride=stride, padding=1)
        self.bn = BatchNorm2d(filters)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x.to(self.conv.weight.dtype))))


class PolicyNet(nn.Module):
    """Five conv blocks, 512 then 256 channels, strides 1 1 2 1 2."""

    FLAX_NAMES = {"blocks": "_ConvBNRelu"}

    def __init__(self, in_ch: int):
        super().__init__()
        blocks = []
        for filters, stride in POLICY_PLAN:
            blocks.append(_ConvBNRelu(in_ch, filters, stride))
            in_ch = filters
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        for block in self.blocks:
            x = block(x)
        return x


class KMGenerator(nn.Module):
    """Flatten (channels-last) -> 256 -> ReLU -> 128 -> ReLU -> ``out_size``."""

    FLAX_NAMES = {"fc": "Dense"}

    def __init__(self, in_features: int, out_size: int):
        super().__init__()
        self.fc = nn.ModuleList([nn.Linear(in_features, 256),
                                 nn.Linear(256, 128),
                                 nn.Linear(128, out_size)])

    def forward(self, feat):
        """feat (N, C, h, w) -> (N, out_size)."""
        x = feat.permute(0, 2, 3, 1).reshape(feat.shape[0], -1)
        x = torch.relu(_dense(self.fc[0], x))
        x = torch.relu(_dense(self.fc[1], x))
        return _dense(self.fc[2], x)


class When2comFusion(nn.Module):
    """The ``when2com_fusion`` config block: (B, L, C, H, W) -> (B, C, H, W),
    for maps of the configuration's ``H`` x ``W``."""

    FLAX_NAMES = {"policy": "PolicyNet_0", "query_proj": "Dense_0"}

    def __init__(self, args: dict, channels: int):
        super().__init__()
        self.mode = args.get("mode", "softmax")
        self.discrete_ratio = float(args["voxel_size"][0])
        self.downsample_rate = float(args["downsample_rate"])
        self.hw = int(args["H"]), int(args["W"])
        ph, pw = policy_hw(*self.hw)
        flat = ph * pw * POLICY_PLAN[-1][0]
        self.policy = PolicyNet(int(channels))
        self.key_net = KMGenerator(flat, int(args["key_size"]))
        self.query_net = KMGenerator(flat, int(args["query_size"]))
        self.query_proj = nn.Linear(int(args["query_size"]), int(args["key_size"]))

    def forward(self, x, agent_mask, pairwise_t_full):
        """x (B, L, C, H, W); agent_mask (B, L) bool; pairwise_t_full (B, L,
        L, 4, 4), whose ego row [:, 0] warps every agent into the ego."""
        b, l, c, h, w = x.shape
        if (h, w) != self.hw:
            raise ValueError(f"When2com was built for {self.hw} maps, got "
                             f"{(h, w)}: its MLPs' input size follows H and W")
        aff = normalized_pairwise_affine(
            pairwise_t_full, h, w, self.discrete_ratio, self.downsample_rate)
        warped = warp_affine_normalized(x.permute(0, 1, 3, 4, 2), aff[:, 0])
        qk = self.policy(warped.reshape(b * l, h, w, c).permute(0, 3, 1, 2))
        keys = self.key_net(qk).reshape(b, l, -1)
        query = self.query_net(qk.reshape((b, l) + qk.shape[1:])[:, 0])
        query = _dense(self.query_proj, query)
        scores = torch.einsum("blk,bk->bl", keys, query)
        attn = torch.softmax(scores.masked_fill(~agent_mask, NEG_INF), dim=-1)
        if self.mode == "activated":
            attn = attn * (attn > ACTIVATION_THRESHOLD).to(attn.dtype)
        # bf16 weights times f32 maps: f32, as JAX promotes
        fused = torch.einsum("bl,blhwc->bhwc", attn.to(warped.dtype), warped)
        return fused.permute(0, 3, 1, 2)
