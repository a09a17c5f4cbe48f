"""Candidate bitmaps as plain tensor ops, and their host-side unpack.

The boundary half of the reference's ``ChunkDigestEngine``: a batch of
windows, each prefixed by the 31 bytes before it in the stream, becomes two
packed candidate bitmaps (one per FastCDC mask). This module holds the plain
PyTorch formulation; ops/gear_cuda.py launches the hand-written kernel and
takes this function as its CPU path and on-card oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import gear
from nydus_snapshotter_tpu_torch.tensors import as_int32


def _hash_bitmaps_kernel(x: torch.Tensor, mask_s: int, mask_l: int, n: int):
    """Batch of windows -> packed candidate bitmaps.

    x: uint8[B, n + GEAR_WINDOW - 1] (window prefixed by its 31-byte tail)
    returns (int32[B, n//32], int32[B, n//32]) u32 bit patterns; bit j of
    word w is position 32w + j.
    """
    h = gear.windowed_gear_sum(gear.mix32_torch(x))[:, gear.GEAR_WINDOW - 1 :]
    lanes = torch.ones(32, dtype=torch.int64, device=x.device) << torch.arange(
        32, dtype=torch.int64, device=x.device
    )

    def pack(bits: torch.Tensor) -> torch.Tensor:
        words = (bits.reshape(-1, n // 32, 32).to(torch.int64) * lanes).sum(-1)
        return as_int32(words)

    return pack((h & mask_s) == 0), pack((h & mask_l) == 0)


def _unpack_positions(words: np.ndarray, valid_len: int) -> np.ndarray:
    """uint32 packed bitmap -> sorted candidate positions < valid_len."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    pos = np.nonzero(bits)[0]
    return pos[pos < valid_len]
