from airv2x_tpu_torch.config.loader import load_yaml

__all__ = ["load_yaml"]
