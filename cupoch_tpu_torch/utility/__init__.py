"""Shape, device, console, transform and solver helpers."""
from . import console, eigen, shape, transforms
from .device import resolve_device

__all__ = ["console", "eigen", "shape", "transforms", "resolve_device"]
