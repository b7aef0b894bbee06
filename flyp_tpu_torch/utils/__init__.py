from .pipeline import OneStepLag, host_cast_images, to_device

__all__ = ["OneStepLag", "host_cast_images", "to_device"]
