from airv2x_tpu_torch.config.loader import load_yaml, save_yaml

__all__ = ["load_yaml", "save_yaml"]
