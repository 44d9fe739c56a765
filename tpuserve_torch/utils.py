"""Small shared helpers (the port's copy of ``tpuserve/utils/misc.py``,
without the JAX device-sync helper)."""

from __future__ import annotations

import os


def env_flag(name: str, default: bool = True) -> bool:
    """Boolean env-var parse: "0"/"false"/"off"/"no" are false, anything
    else true, unset is ``default``."""
    val = os.environ.get(name)
    if val is None:
        return default
    return val.strip().lower() not in ("0", "false", "off", "no")


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    return cdiv(x, multiple) * multiple


def next_power_of_2(x: int) -> int:
    """Smallest power of two >= x (>=1)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()
