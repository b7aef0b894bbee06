from .pipeline import OneStepLag, host_cast_images, lagged_device_method, to_device

__all__ = ["OneStepLag", "host_cast_images", "lagged_device_method", "to_device"]
