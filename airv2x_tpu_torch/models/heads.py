"""Detection heads: cls / reg / obj 1x1 convs (counterpart of
airv2x_tpu/models/heads.py:DetectionHeads). Outputs stay NCHW here; the
model turns them NHWC at its public output."""

from __future__ import annotations

from torch import nn


class DetectionHeads(nn.Module):
    def __init__(self, in_ch: int, anchor_number: int, num_class: int):
        super().__init__()
        self.cls_head = nn.Conv2d(in_ch, anchor_number * num_class, 1)
        self.reg_head = nn.Conv2d(in_ch, 7 * anchor_number, 1)
        self.obj_head = nn.Conv2d(in_ch, anchor_number, 1)

    def forward(self, x):
        return {"psm": self.cls_head(x), "rm": self.reg_head(x),
                "obj": self.obj_head(x)}
