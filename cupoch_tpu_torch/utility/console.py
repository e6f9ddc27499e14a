"""Logging / verbosity with the stdlib `logging` module, mirroring
cupoch's spdlog wrapper (levels Off .. Debug)."""
from __future__ import annotations

import enum
import logging
import sys
import time


class VerbosityLevel(enum.IntEnum):
    Off = 0
    Fatal = 1
    Error = 2
    Warning = 3
    Info = 4
    Debug = 5


_LEVEL_MAP = {
    VerbosityLevel.Off: logging.CRITICAL + 10,
    VerbosityLevel.Fatal: logging.CRITICAL,
    VerbosityLevel.Error: logging.ERROR,
    VerbosityLevel.Warning: logging.WARNING,
    VerbosityLevel.Info: logging.INFO,
    VerbosityLevel.Debug: logging.DEBUG,
}

logger = logging.getLogger("cupoch_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "[cupoch_tpu_torch %(levelname)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)


def set_verbosity_level(level: VerbosityLevel) -> None:
    logger.setLevel(_LEVEL_MAP[VerbosityLevel(level)])


def get_verbosity_level() -> VerbosityLevel:
    inv = {v: k for k, v in _LEVEL_MAP.items()}
    return inv.get(logger.level, VerbosityLevel.Warning)


def log_error(msg, *args):
    logger.error(msg, *args)
    raise RuntimeError(msg % args if args else msg)


def log_warning(msg, *args):
    logger.warning(msg, *args)


def log_info(msg, *args):
    logger.info(msg, *args)


def log_debug(msg, *args):
    logger.debug(msg, *args)


class ConsoleProgressBar:
    """Text progress bar on stderr (cupoch utility/console.h
    ConsoleProgressBar): redrawn at most every 0.1 s and at the end."""

    def __init__(self, expected_count: int, progress_info: str = "",
                 active: bool = True):
        self.expected = max(int(expected_count), 1)
        self.info = progress_info
        self.active = active
        self.count = 0
        self._last = 0.0

    def step(self, n: int = 1):
        self.count += n
        now = time.time()
        if self.active and (now - self._last > 0.1
                            or self.count >= self.expected):
            frac = min(self.count / self.expected, 1.0)
            bar = "=" * int(frac * 40)
            sys.stderr.write(f"\r{self.info} [{bar:<40}] {frac*100:5.1f}%")
            if self.count >= self.expected:
                sys.stderr.write("\n")
            sys.stderr.flush()
            self._last = now
        return self

    __iadd__ = step
