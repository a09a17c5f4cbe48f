"""Content-defined chunking: two-phase FastCDC on top of the gear hash.

Phase 1 (device, parallel): judge every byte position with the
position-independent gear hash (ops/gear.py, kernel ops/gear_cuda.py)
against two FastCDC masks, yielding two sparse candidate-position sets.

Phase 2 (host, sequential over *candidates*, not bytes): resolve actual cut
points with min/normal/max-size rules by binary-searching the candidate
arrays — O(chunks · log candidates), microseconds per GiB, so the sequential
dependency costs nothing.

The chunk-size knob carries the reference's bounds (``--chunk-size`` must be
a power of two in 0x1000..0x1000000, pkg/converter/types.go:76-79).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from nydus_snapshotter_tpu_torch import constants
from nydus_snapshotter_tpu_torch.ops import gear


class CDCError(ValueError):
    pass


@dataclass(frozen=True)
class CDCParams:
    """FastCDC parameters derived from the average (normal) chunk size.

    Normalization level 2: positions before the normal size use a mask with
    two *more* bits (harder to match, biasing cuts toward normal size),
    positions after use two *fewer* bits.
    """

    avg_size: int

    def __post_init__(self):
        avg = self.avg_size
        if avg & (avg - 1) or not (
            constants.CHUNK_SIZE_MIN <= avg <= constants.CHUNK_SIZE_MAX
        ):
            raise CDCError(
                f"chunk size must be a power of two in "
                f"[{constants.CHUNK_SIZE_MIN:#x}, {constants.CHUNK_SIZE_MAX:#x}], "
                f"got {avg:#x}"
            )

    @property
    def min_size(self) -> int:
        return self.avg_size // 4

    @property
    def normal_size(self) -> int:
        return self.avg_size

    @property
    def max_size(self) -> int:
        return min(self.avg_size * 4, constants.CHUNK_SIZE_MAX * 4)

    @property
    def bits(self) -> int:
        return self.avg_size.bit_length() - 1

    @property
    def mask_small(self) -> int:  # used below normal size: harder match
        return (1 << (self.bits + 2)) - 1

    @property
    def mask_large(self) -> int:  # used above normal size: easier match
        return (1 << (self.bits - 2)) - 1


def candidates_from_hashes(hashes: np.ndarray, params: CDCParams) -> tuple[np.ndarray, np.ndarray]:
    """Sparse candidate positions for each mask from per-position hashes.

    A candidate at position ``i`` means "a chunk may end at i+1" (the hash
    covers the window ending at byte i).
    """
    h = np.asarray(hashes)
    cand_s = np.nonzero((h & np.uint32(params.mask_small)) == 0)[0]
    cand_l = np.nonzero((h & np.uint32(params.mask_large)) == 0)[0]
    return cand_s, cand_l


def resolve_cuts(
    cand_s: np.ndarray,
    cand_l: np.ndarray,
    total_len: int,
    params: CDCParams,
) -> np.ndarray:
    """Greedy FastCDC cut resolution over sparse candidates.

    Returns cut offsets (exclusive chunk ends), final ``total_len`` included.
    Bit-identical to the byte-sequential reference chunker
    (``chunk_sequential_reference``) because judged positions always lie
    >= min_size >= GEAR_WINDOW past the chunk start, where the
    position-independent hash equals the per-chunk-reset hash.
    """
    if params.min_size < gear.GEAR_WINDOW:
        raise CDCError(
            f"min chunk size {params.min_size} < gear window {gear.GEAR_WINDOW}; "
            "parallel/sequential equivalence would break"
        )
    n = total_len
    cuts = []
    start = 0
    while n - start > params.min_size:
        # Earliest small-mask candidate with length in [min, normal).
        cut = _first_candidate_in(
            cand_s, start + params.min_size - 1, min(start + params.normal_size - 1, n)
        )
        if cut is None:
            # Then large-mask candidate with length in [normal, max).
            cut = _first_candidate_in(
                cand_l, start + params.normal_size - 1, min(start + params.max_size - 1, n)
            )
        if cut is not None:
            end = cut + 1
        elif n - start > params.max_size:
            end = start + params.max_size  # forced cut
        else:
            end = n  # tail with no content cut
        cuts.append(end)
        start = end
    if n > start:
        cuts.append(n)
    return np.asarray(cuts, dtype=np.int64)


def _first_candidate_in(cand: np.ndarray, lo: int, hi: int) -> int | None:
    """First candidate position in [lo, hi), or None."""
    idx = np.searchsorted(cand, lo, side="left")
    if idx < len(cand) and cand[idx] < hi:
        return int(cand[idx])
    return None


def cuts_to_extents(cuts: np.ndarray) -> list[tuple[int, int]]:
    """[(offset, size), ...] from cut offsets."""
    out = []
    prev = 0
    for cut in cuts:
        out.append((prev, int(cut) - prev))
        prev = int(cut)
    return out


# ---------------------------------------------------------------------------
# Whole-stream helpers
# ---------------------------------------------------------------------------


_NP_WINDOW = 1 << 20


def chunk_data_np(data: bytes | np.ndarray, params: CDCParams) -> np.ndarray:
    """CPU path: cut offsets for a whole in-memory stream.

    Hashes are computed per 1 MiB window with the 31-byte tail carried
    across seams (bit-identical to whole-stream hashing) so peak memory is
    a few MiB regardless of stream length — this is the streaming Pack's
    fallback when the native chunker isn't built.
    """
    arr = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    if arr.size == 0:
        return np.asarray([], dtype=np.int64)
    parts_s, parts_l = [], []
    for lo in range(0, arr.size, _NP_WINDOW):
        hi = min(lo + _NP_WINDOW, arr.size)
        tail = arr[max(0, lo - (gear.GEAR_WINDOW - 1)) : lo]
        if len(tail) < gear.GEAR_WINDOW - 1:
            tail = np.concatenate(
                [np.zeros(gear.GEAR_WINDOW - 1 - len(tail), dtype=np.uint8), tail]
            )
        h = gear.gear_hashes_np(arr[lo:hi], prev_tail=tail)
        cs, cl = candidates_from_hashes(h, params)
        parts_s.append(cs + lo)
        parts_l.append(cl + lo)
    cand_s = np.concatenate(parts_s)
    cand_l = np.concatenate(parts_l)
    return resolve_cuts(cand_s, cand_l, arr.size, params)


def chunk_fixed(total_len: int, chunk_size: int) -> np.ndarray:
    """Fixed-size chunking (the nydus default ``--chunk-size`` behavior)."""
    if chunk_size <= 0:
        raise CDCError("chunk size must be positive")
    cuts = list(range(chunk_size, total_len, chunk_size))
    cuts.append(total_len)
    return np.asarray(cuts if total_len else [], dtype=np.int64)


# ---------------------------------------------------------------------------
# Sequential ground truth (differential-test oracle)
# ---------------------------------------------------------------------------


def chunk_sequential_reference(data: bytes, params: CDCParams) -> np.ndarray:
    """Classic byte-at-a-time FastCDC with per-chunk hash reset.

    Deliberately naive and slow — exists solely as the oracle the parallel
    two-phase pipeline must match bit-for-bit.
    """
    table = gear.gear_table()
    n = len(data)
    cuts = []
    start = 0
    while n - start > params.min_size:
        h = 0
        end = None
        scan_end = min(start + params.max_size, n)
        for i in range(start, scan_end):
            h = ((h << 1) + int(table[data[i]])) & 0xFFFFFFFF
            length = i + 1 - start
            if length < params.min_size:
                continue
            mask = params.mask_small if length < params.normal_size else params.mask_large
            if (h & mask) == 0:
                end = i + 1
                break
        if end is None:
            end = start + params.max_size if scan_end == start + params.max_size else n
        cuts.append(end)
        start = end
    if n > start:
        cuts.append(n)
    return np.asarray(cuts, dtype=np.int64)
