from airv2x_tpu_torch.models.registry import MODEL_REGISTRY, build_model

__all__ = ["MODEL_REGISTRY", "build_model"]
