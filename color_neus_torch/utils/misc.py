"""Small shared utilities: port of color_neus_tpu/utils/misc.py.

Immutable constants and the config pretty-print (reference
lib/utils/misc.py:84-95 CONST, :104-125 format_cfg / format_args_cfg);
termcolor colours the keys where it is importable.
"""

from __future__ import annotations

import math

import numpy as np


class _Immutable(type):
    def __setattr__(cls, name, value):
        raise AttributeError(f"CONST.{name} is immutable")


class CONST(metaclass=_Immutable):
    """Process-wide constants (reference misc.py:84-95)."""
    PI = math.pi
    INT_MAX = 2 ** 32 - 1
    # camera-frame flip between OpenCV and OpenGL/pyrender conventions
    PYRENDER_EXTRINSIC = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


def _color(s: str, c: str) -> str:
    try:
        from termcolor import colored
    except ImportError:
        return s
    return colored(s, c)


def format_cfg(cfg, level: int = 0) -> str:
    """Indented, colored, human-readable dump of a nested config
    (reference misc.py:104-118). Works on any dict/list/scalar tree."""
    pad = "  " * level
    if isinstance(cfg, dict):
        return "".join(f"\n{pad} * {_color(str(k), 'magenta')}:"
                       f"{format_cfg(v, level + 1)}" for k, v in cfg.items())
    if isinstance(cfg, (list, tuple)):
        return "".join(f"\n{pad} - {format_cfg(v, level + 1)}"
                       for v in cfg) + "\n"
    return f" {cfg}"


def format_args_cfg(args, cfg=None) -> str:
    """CLI args + config in one printable block (misc.py:121-125)."""
    lines = [f" - {_color(k, 'green')}: {getattr(args, k)}"
             for k in vars(args)] if args is not None else []
    return "\n".join(lines) + (format_cfg(cfg) if cfg else "")
