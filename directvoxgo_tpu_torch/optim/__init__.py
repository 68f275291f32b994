from .masked_adam import MaskedAdam  # noqa: F401
