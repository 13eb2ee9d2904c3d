"""AirV2X STAMP and SiCP (counterpart of airv2x_tpu/models/stamp_model.py),
det and seg, in eval and train mode.

STAMP is the HEAL pipeline with a per-type adapter (``adapter_<type>``,
``fusion/adapter.py``) between the modality backbone and the pyramid, for
each agent type present whose config block has an ``adapter``; it reads no
``cam_crop_ratios``.

SiCP runs the shared spine of ``PostBackboneFusionModel`` (one backbone
pass and the shrink per agent) and fuses the ego with each sender through
``fusion/sicp.py:SpatialFusion``. In train mode it returns the heads of the
ego's own map (``psm1`` / ``rm1`` / ``obj1``, seg ``dynamic_seg1`` /
``static_seg1``) and of the fused map (``...2``, and again under the plain
names); in eval the fused map's.
"""

from __future__ import annotations

import torch

from airv2x_tpu_torch.models.base import AGENT_TYPES
from airv2x_tpu_torch.models.fusion.adapter import Adapter
from airv2x_tpu_torch.models.fusion.sicp import SpatialFusion
from airv2x_tpu_torch.models.heal_model import Airv2xHEAL
from airv2x_tpu_torch.models.intermediate_models import PostBackboneFusionModel


class Airv2xSTAMP(Airv2xHEAL):
    def make_alignnet(self, args: dict):
        """None: the JAX package's STAMP reads no ``alignnet`` key."""
        return None

    def make_adapters(self, args: dict) -> None:
        self.adapter_types = []
        for i, t in enumerate(AGENT_TYPES):
            if self.layout.counts[i] and "adapter" in args[t]:
                self.add_module(f"adapter_{t}", Adapter(args[t]["adapter"]))
                self.adapter_types.append(t)

    def adapted_channels(self) -> int:
        widths = {int(self.args[t]["adapter"]["args"]["out_channels"])
                  if t in self.adapter_types
                  else self.modality_backbone.out_channels
                  for i, t in enumerate(AGENT_TYPES) if self.layout.counts[i]}
        if len(widths) != 1:
            raise ValueError(f"agent types disagree on the protocol width: "
                             f"{widths}")
        return widths.pop()

    def adapt(self, grouped):
        parts = []
        for t in AGENT_TYPES:
            sl = self.layout.slots(t)
            if sl.stop == sl.start:
                continue
            ft = grouped[:, sl]
            if t in self.adapter_types:
                out = self.get_submodule(f"adapter_{t}")(ft.flatten(0, 1))
                ft = out.reshape(ft.shape[:2] + out.shape[1:])
            parts.append(ft)
        return torch.cat(parts, dim=1)

    def crop_ratios(self, batch):
        return None


class Airv2xSiCP(PostBackboneFusionModel):
    """``sicp_fusion.in_channels`` is one agent's width and is doubled for
    the pair; a ``fusion`` block gives the pair's width already doubled."""

    def make_fusion(self, args, channels):
        fcfg = args.get("sicp_fusion")
        if fcfg is not None:
            in_ch = int(fcfg["in_channels"]) * 2
        else:
            fcfg = args["fusion"]
            in_ch = int(fcfg["in_channels"])
        self.sicp_cfg = fcfg
        return SpatialFusion(in_ch, int(fcfg["out_channels"]))

    def fuse(self, feats, batch):
        return self.fusion_net(
            feats, batch["agent_mask"], batch["pairwise_t_full"],
            discrete_ratio=self.sicp_cfg.get("voxel_size", [0.4])[0],
            downsample_rate=self.sicp_cfg.get("downsample_rate", 2))

    def forward(self, batch):
        feats = self.backbone(self.encode(batch))
        out = self.heads(self.fuse(feats, batch))
        if self.training:
            single = self.heads(feats[:, 0])
            heads = [k for k in out if k != "comm_rate"]
            out.update({f"{k}1": single[k] for k in heads})
            out.update({f"{k}2": out[k] for k in heads})
        return out
