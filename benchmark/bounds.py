"""The card's peaks and the work each kernel's function needs: the frozen
roofline arithmetic.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM3, and
132 SMs x 64 INT32 lanes (4 partitions of 16 a clock) at the 1 980 MHz boost
clock, 16.73 Tops/s of 32-bit integer operations. The peak is taken at the
boost clock whatever clock a card runs at, so a slow clock lowers the share
and never the peak.

Operation counts are the fewest each FUNCTION needs on this instruction set
(LOP3 = any 3-input logic operation, IADD3 = a 3-input add, SHF = a rotate),
not what the current kernels issue; copied from ``chip_smoke.py``, where
their derivations are spelt out:

- K1, gear-hash candidate bitmaps, per byte position: one table lookup, one
  shift-add, two mask tests of an and and a compare each: 6.
- K2, SHA-256, per padded 64-byte block: 64 rounds x 14, 48 schedule steps
  x 10, 8 state adds, 16 byte swaps: 1 400.
- K4, BLAKE3, per 64-byte compression: 7 rounds x 8 G x 12, 8 output xors:
  680. A chunk of n leaves takes every leaf's blocks (at least one) and
  n - 1 parent compressions.

Bytes are each input byte read once and each output byte written once. A
kernel's bound is the larger of its bytes over the HBM peak and its
operations over the INT32 peak. K2's and K4's serial terms (a chunk's
dependent chain) are properties of one instruction schedule, not of the
card; they are printed on their own line and never enter a roofline.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
SMS = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ

K1_OPS_PER_POS = 1 + 1 + 2 * 2
K2_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 16
K4_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8
# the digest kernels' per-chunk traffic besides the chunk: offset and size
# in (int32 each), 32 bytes of digest out
CHUNK_META_BYTES = 4 + 4 + 32


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def k1_bound_s(positions: int) -> float:
    """K1 over ``positions`` bytes of files: each byte read, and one bit
    per position out in each of the two candidate bitmaps."""
    return bound_s(positions + 2 * positions / 8, positions * K1_OPS_PER_POS)


def sha256_blocks(sizes: np.ndarray) -> np.ndarray:
    """Padded SHA-256 blocks of chunks of these sizes."""
    return (np.asarray(sizes, dtype=np.int64) + 8) // 64 + 1


def k2_bound_s(sizes: np.ndarray) -> float:
    sizes = np.asarray(sizes, dtype=np.int64)
    return bound_s(float(sizes.sum()) + sizes.size * CHUNK_META_BYTES,
                   float(sha256_blocks(sizes).sum()) * K2_OPS_PER_BLOCK)


def blake3_compressions(sizes: np.ndarray) -> float:
    """BLAKE3 compressions of chunks of these sizes: every leaf's 64-byte
    blocks (an empty chunk one), then one parent per merge."""
    s = np.asarray(sizes, dtype=np.int64)
    leaves = np.maximum((s + 1023) // 1024, 1)
    blocks = (s // 1024) * 16 + ((s % 1024) + 63) // 64 + (s == 0)
    return float(blocks.sum() + (leaves - 1).sum())


def k4_bound_s(sizes: np.ndarray) -> float:
    sizes = np.asarray(sizes, dtype=np.int64)
    return bound_s(float(sizes.sum()) + sizes.size * CHUNK_META_BYTES,
                   blake3_compressions(sizes) * K4_OPS_PER_COMPRESSION)


def k2_serial_blocks(sizes: np.ndarray) -> int:
    """The longest chunk's blocks: K2's dependent chain, 64 rounds each."""
    return int(sha256_blocks(sizes).max()) if len(sizes) else 0


def k4_chain(sizes: np.ndarray) -> int:
    """K4's dependent compressions: the longest leaf's blocks (at most 16),
    then one parent per tree level."""
    s = np.asarray(sizes, dtype=np.int64)
    if not len(s):
        return 0
    leaves = int(np.maximum((s.max() + 1023) // 1024, 1))
    return int(min((s.max() + 63) // 64, 16)) + int(np.ceil(np.log2(leaves)))
