"""Human-readable formatting helpers (reference pkg/utils/display)."""

from __future__ import annotations


def byte_to_readable_iec(n: int) -> str:
    """1536 -> \"1.5 KiB\" (display.go ByteToReadableIEC)."""
    if n < 1024:
        return f"{n} B"
    value = float(n)
    for unit in ("KiB", "MiB", "GiB", "TiB", "PiB", "EiB"):
        value /= 1024.0
        if value < 1024.0:
            return f"{value:.1f} {unit}"
    return f"{value:.1f} ZiB"


def microsecond_to_readable(us: int) -> str:
    """1500000 -> \"1.5 s\" (display.go MicroSecondToReadable)."""
    if us < 1000:
        return f"{us} us"
    if us < 1000_000:
        return f"{us / 1000.0:.1f} ms"
    return f"{us / 1000_000.0:.1f} s"
