"""Shape, device, console, transform and solver helpers and the LZF
codec (`dl_converter`, DLPack interop, loads with the package)."""
from . import console, eigen, lzf, shape, transforms
from .device import resolve_device

__all__ = ["console", "eigen", "lzf", "shape", "transforms",
           "resolve_device"]
