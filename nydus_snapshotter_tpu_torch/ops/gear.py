"""Gear rolling hash — the CDC primitive, computed position-parallel.

A 32-bit gear hash ``h_i = (h_{i-1} << 1) + G[x_i]`` forgets bytes older than
32 positions (each shift drops one bit of history), so

    h_i = sum_{k=0}^{31} G[x_{i-k}] << k        (mod 2^32)

which is 32 shifted adds over a byte window: position-parallel, no scan.
Because judged cut positions always sit >= min_size >= 32 bytes past their
chunk start, this position-independent value is bit-identical to the
classic sequential FastCDC hash that resets per chunk.

``G`` is the gear table ``G[b] = mix32(b)``. The numpy functions are the host
reference (copied from the reference package so host-only importers need
no torch); the torch functions are the plain device formulation, computing
in int64 masked to 32 bits (CPU torch has no uint32 arithmetic).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.tensors import MASK32

# Effective window of a 32-bit gear hash: one byte of history per shift.
GEAR_WINDOW = 32

# fmix32 constants (MurmurHash3 finalizer — full avalanche in 5 steps).
_MIX_C0 = np.uint32(0x9E3779B1)  # golden-ratio odd multiplier, lifts 0..255
_MIX_C1 = np.uint32(0x85EBCA6B)
_MIX_C2 = np.uint32(0xC2B2AE35)


def mix32_np(x: np.ndarray) -> np.ndarray:
    """The gear mixing function: uint32 -> uint32, elementwise.

    This IS the table derivation: ``gear_table()[b] == mix32(b)``. Kernels
    compute it inline; host paths keep the 256-entry table with identical
    contents, so cut points are reproducible across every backend.
    """
    x = x.astype(np.uint32)
    with np.errstate(over="ignore"):
        x = (x + np.uint32(1)) * _MIX_C0
        x ^= x >> np.uint32(16)
        x *= _MIX_C1
        x ^= x >> np.uint32(13)
        x *= _MIX_C2
        x ^= x >> np.uint32(16)
    return x


@functools.cache
def gear_table() -> np.ndarray:
    """The 256-entry gear table: ``table[b] = mix32(b)``."""
    return mix32_np(np.arange(256, dtype=np.uint32))


def gear_hashes_np(data: np.ndarray, prev_tail: np.ndarray | None = None) -> np.ndarray:
    """CPU reference: hash at every position of ``data`` (uint8[N] -> uint32[N]).

    ``prev_tail`` is the previous GEAR_WINDOW-1 bytes of the stream when
    ``data`` is a window of a longer stream (zeros at stream start).
    """
    if prev_tail is None:
        prev_tail = np.zeros(GEAR_WINDOW - 1, dtype=np.uint8)
    if len(prev_tail) != GEAR_WINDOW - 1:
        raise ValueError(f"prev_tail must be {GEAR_WINDOW - 1} bytes")
    n = len(data)
    x = np.concatenate([prev_tail, np.asarray(data, dtype=np.uint8)])
    g = gear_table()[x]  # uint32[n + 31]
    h = np.zeros(n, dtype=np.uint32)
    for k in range(GEAR_WINDOW):
        start = GEAR_WINDOW - 1 - k
        h += g[start : start + n] << np.uint32(k)
    return h


def mix32_torch(x: torch.Tensor) -> torch.Tensor:
    """mix32 elementwise on a tensor of byte values -> int64 in [0, 2^32).

    The int64 products wrap modulo 2^64; only their low 32 bits are kept,
    which are the u32 products.
    """
    x = x.to(torch.int64)
    x = ((x + 1) * int(_MIX_C0)) & MASK32
    x = x ^ (x >> 16)
    x = (x * int(_MIX_C1)) & MASK32
    x = x ^ (x >> 13)
    x = (x * int(_MIX_C2)) & MASK32
    return x ^ (x >> 16)


def windowed_gear_sum(g: torch.Tensor) -> torch.Tensor:
    """h[i] = sum_{k=0}^{31} g[i-k] << k (mod 2^32) over the last axis, zeros
    off the left edge; int64 in, int64 in [0, 2^32) out.

    Log-doubling: S_1 = g, S_2m[i] = S_m[i] + S_m[i-m] << m — 5 shifted-add
    passes instead of 32.
    """
    s = g
    length = s.shape[-1]
    m = 1
    while m < GEAR_WINDOW:
        k = min(m, length)
        zeros = torch.zeros((*s.shape[:-1], k), dtype=s.dtype, device=s.device)
        shifted = torch.cat([zeros, s[..., : length - k]], dim=-1)
        s = (s + (shifted << m)) & MASK32
        m *= 2
    return s
