"""Plain FastCDC as the port defines it: the gear hash, two masks, greedy cuts.

A frozen copy of the port's plain chunker (``ops/gear.py``, ``ops/cdc.py``),
written again in numpy so that it imports nothing of the port:

- gear table ``G[b] = mix32(b)`` (the MurmurHash3 finalizer of ``b + 1``
  times the golden-ratio constant);
- ``h_i = sum_{k<32} G[x_{i-k}] << k (mod 2^32)``, computed by doubling:
  ``S_2m[i] = S_m[i] + (S_m[i-m] << m)``;
- normalized FastCDC at level 2 for an average size ``avg``: minimum
  ``avg / 4``, maximum ``4 avg``; below ``avg`` a cut needs the low
  ``log2(avg) + 2`` bits of ``h`` zero, from ``avg`` on the low
  ``log2(avg) - 2``; a cut after byte ``i`` ends the chunk at ``i + 1``.
"""

from __future__ import annotations

import numpy as np

WINDOW = 32
_STEP = 1 << 22  # bytes hashed per numpy pass


def _mix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = (x + np.uint32(1)) * np.uint32(0x9E3779B1)
        x ^= x >> np.uint32(16)
        x *= np.uint32(0x85EBCA6B)
        x ^= x >> np.uint32(13)
        x *= np.uint32(0xC2B2AE35)
        x ^= x >> np.uint32(16)
    return x


GEAR = _mix32(np.arange(256))


def gear_hashes(data: np.ndarray) -> np.ndarray:
    """The gear hash after every byte of ``data`` (zeros before its start)."""
    n = data.size
    out = np.empty(n, dtype=np.uint32)
    for lo in range(0, n, _STEP):
        hi = min(n, lo + _STEP)
        pre = min(lo, WINDOW - 1)
        s = GEAR[data[lo - pre : hi]]
        m = 1
        while m < WINDOW:
            s[m:] += s[:-m] << np.uint32(m)  # the shifted operand is a new array
            m *= 2
        out[lo:hi] = s[pre:]
    return out


def cuts(data: np.ndarray, avg: int) -> np.ndarray:
    """Exclusive chunk ends of one file, its length last."""
    n = data.size
    lo_size, hi_size = avg // 4, avg * 4
    bits = avg.bit_length() - 1
    out = []
    if n > lo_size:
        h = gear_hashes(data)
        small = np.flatnonzero((h & np.uint32((1 << (bits + 2)) - 1)) == 0)
        large = np.flatnonzero((h & np.uint32((1 << (bits - 2)) - 1)) == 0)
        start = 0
        while n - start > lo_size:
            end = _first(small, start + lo_size - 1, min(start + avg - 1, n))
            if end is None:
                end = _first(large, start + avg - 1, min(start + hi_size - 1, n))
            if end is not None:
                end += 1
            elif n - start > hi_size:
                end = start + hi_size
            else:
                end = n
            out.append(end)
            start = end
        if n > start:
            out.append(n)
    elif n:
        out.append(n)
    return np.asarray(out, dtype=np.int64)


def _first(cand: np.ndarray, lo: int, hi: int) -> int | None:
    """The first candidate in [lo, hi)."""
    i = np.searchsorted(cand, lo)
    return int(cand[i]) if i < cand.size and cand[i] < hi else None
