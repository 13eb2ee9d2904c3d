__all__ = ["MODEL_REGISTRY", "build_model"]


def __getattr__(name):
    # the registry imports every model, and some models import
    # ``ops/fast_pillars.py``, which imports ``models/nn.py``: loading the
    # registry when the package is first imported made importing
    # ``ops.fast_pillars`` first a circular import
    if name in __all__:
        from airv2x_tpu_torch.models import registry

        return getattr(registry, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
