"""Gear-hash candidate bitmaps: the hand-written kernel K1 and its wrapper.

Counterpart of the reference's ops/gear_pallas.py with the same signature:
``gear_bitmaps(x u8[B, n+31], mask_s, mask_l, n)`` returns two packed
bitmaps in stream order. A CPU tensor takes the plain version
(ops/chunker._hash_bitmaps_kernel); a CUDA tensor launches
csrc/gear_bitmaps.cu or raises. The kernel computes the rolling recurrence
h = (h << 1) + mix32(x), each thread over a run of ``RUN`` positions that
it enters 31 bytes early from h = 0.
"""

from __future__ import annotations

import ctypes

import torch

from nydus_snapshotter_tpu_torch.ops import chunker, cuda_build, gear

TAIL = gear.GEAR_WINDOW - 1  # 31
RUN = 64  # positions per thread of csrc/gear_bitmaps.cu (its kRun)

KERNEL = cuda_build.Kernel(
    "gear_bitmaps.cu",
    "ntpu_gear_bitmaps",
    [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_void_p,
    ],
)

MAX_ROWS = 65535  # grid.y limit


def gear_bitmaps_plain(x: torch.Tensor, mask_s: int, mask_l: int, n: int):
    """The plain PyTorch version of K1 (any device)."""
    return chunker._hash_bitmaps_kernel(x, mask_s, mask_l, n)


def gear_bitmaps(x: torch.Tensor, mask_s: int, mask_l: int, n: int):
    """x: u8[B, n+31] stream-order windows with 31-byte tail prefix ->
    (int32[B, n//32], int32[B, n//32]) candidate bitmaps (u32 patterns)."""
    if x.dtype != torch.uint8 or x.dim() != 2 or x.shape[1] != n + TAIL:
        raise ValueError(f"want u8[B, {n + TAIL}], got {x.dtype}{list(x.shape)}")
    if n % 32:
        raise ValueError(f"n must be a multiple of 32, got {n}")
    if not (0 <= mask_s <= 0xFFFFFFFF and 0 <= mask_l <= 0xFFFFFFFF):
        raise ValueError("masks must be u32")
    if x.device.type == "cpu":
        return gear_bitmaps_plain(x, mask_s, mask_l, n)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    rows = x.shape[0]
    if rows > MAX_ROWS:
        raise ValueError(f"{rows} rows exceed the launch grid ({MAX_ROWS})")
    out_s = torch.empty((rows, n // 32), dtype=torch.int32, device=x.device)
    out_l = torch.empty((rows, n // 32), dtype=torch.int32, device=x.device)
    if rows and n:
        with torch.cuda.device(x.device):
            KERNEL.launch(
                x.data_ptr(), out_s.data_ptr(), out_l.data_ptr(), rows, n,
                mask_s, mask_l, torch.cuda.current_stream().cuda_stream,
            )
    return out_s, out_l
