"""Colour maps (cupoch visualization/utility/color_map.h:30-160),
computed in torch on the values' device over whole arrays.

Each map takes a tensor (kept on its device unless `device` is given)
or anything numpy reads (put on `device`: the card when None) and
returns float32 RGB [..., 3]. The arithmetic is the JAX package's in float32, its Python
constants (the 1/3 steps of the hot map among them) rounded to float32
as JAX's weakly typed constants are.
"""
from __future__ import annotations

import enum

import numpy as np
import torch

from ..utility.device import resolve_device


class ColorMapOption(enum.IntEnum):
    """cupoch color_map.h:32-38."""

    Gray = 0
    Jet = 1
    Summer = 2
    Winter = 3
    Hot = 4


def _values(value, device=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device or value.device, dtype=torch.float32)
    return torch.tensor(np.asarray(value, np.float32),
                        device=resolve_device(device))


def _c(x, like: torch.Tensor) -> torch.Tensor:
    """A float32 constant on `like`'s device (0-d: the card divides by
    a host scalar through its reciprocal)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _interp(value, y0, x0, y1, x1):
    t = ((value - _c(x0, value)) / _c(x1 - x0, value)).clamp(0.0, 1.0)
    return _c(y0, value) + t * _c(y1 - y0, value)


def _jet_base(value):
    """cupoch color_map.h:83-96, JetBase's piecewise ramp."""
    zero, one = torch.zeros_like(value), torch.ones_like(value)
    return torch.where(
        value <= _c(-0.75, value), zero,
        torch.where(value <= _c(-0.25, value),
                    _interp(value, 0.0, -0.75, 1.0, -0.25),
                    torch.where(value <= _c(0.25, value), one,
                                torch.where(value <= _c(0.75, value),
                                            _interp(value, 1.0, 0.25, 0.0,
                                                    0.75),
                                            zero))))


def color_map_gray(value, device=None):
    value = _values(value, device)
    return torch.stack([value, value, value], -1)


def color_map_jet(value, device=None):
    value = _values(value, device)
    two = _c(2.0, value)
    return torch.stack([_jet_base(value * two - _c(1.5, value)),
                        _jet_base(value * two - _c(1.0, value)),
                        _jet_base(value * two - _c(0.5, value))], -1)


def color_map_summer(value, device=None):
    value = _values(value, device)
    return torch.stack([_interp(value, 0.0, 0.0, 1.0, 1.0),
                        _interp(value, 0.5, 0.0, 1.0, 1.0),
                        torch.full_like(value, 0.4)], -1)


def color_map_winter(value, device=None):
    value = _values(value, device)
    return torch.stack([torch.zeros_like(value),
                        _interp(value, 0.0, 0.0, 1.0, 1.0),
                        _interp(value, 1.0, 0.0, 0.5, 1.0)], -1)


def color_map_hot(value, device=None):
    """cupoch color_map.h:116-139 (white -> yellow -> red -> black)."""
    value = _values(value, device)
    e = [_c(c, value) for c in ([1.0, 1.0, 1.0], [1.0, 1.0, 0.0],
                                [1.0, 0.0, 0.0], [0.0, 0.0, 0.0])]
    v = value[..., None]
    third, two_thirds = _c(1 / 3, value), _c(2 / 3, value)
    seg0 = e[0] + (v / third).clamp(0, 1) * (e[1] - e[0])
    seg1 = e[1] + ((v - third) / third).clamp(0, 1) * (e[2] - e[1])
    seg2 = e[2] + ((v - two_thirds) / third).clamp(0, 1) * (e[3] - e[2])
    return torch.where(v < third, seg0,
                       torch.where(v < two_thirds, seg1, seg2))


_MAPS = {
    ColorMapOption.Gray: color_map_gray,
    ColorMapOption.Jet: color_map_jet,
    ColorMapOption.Summer: color_map_summer,
    ColorMapOption.Winter: color_map_winter,
    ColorMapOption.Hot: color_map_hot,
}

_global_option = ColorMapOption.Jet


def get_color_map_color(value, option: ColorMapOption = None, device=None):
    """cupoch GetColorMapColor (color_map.h:141-157): values in [0, 1]
    to float32 RGB [..., 3] under `option` (the global option when
    None)."""
    option = _global_option if option is None else ColorMapOption(option)
    return _MAPS[option](value, device)


def get_global_color_map_option() -> ColorMapOption:
    return _global_option


def set_global_color_map_option(option: ColorMapOption):
    global _global_option
    _global_option = ColorMapOption(option)
