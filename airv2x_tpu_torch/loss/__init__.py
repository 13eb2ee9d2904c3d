from airv2x_tpu_torch.loss.registry import LOSS_REGISTRY, build_loss, register_loss

from airv2x_tpu_torch.loss import depth_loss  # noqa: F401
from airv2x_tpu_torch.loss import point_pillar_binary  # noqa: F401
from airv2x_tpu_torch.loss import point_pillar_multiclass  # noqa: F401
from airv2x_tpu_torch.loss import seg_loss  # noqa: F401
from airv2x_tpu_torch.loss import variants  # noqa: F401

__all__ = ["LOSS_REGISTRY", "build_loss", "register_loss"]
