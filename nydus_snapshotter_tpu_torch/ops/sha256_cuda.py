"""Chunk SHA-256 read straight from the layer buffer: kernel K2 and wrapper.

``sha256_chunks(buffer, offs, sizes)`` digests chunk m = buffer[offs[m] :
offs[m] + sizes[m]] and returns its state words; the extents stay on the
host, where the caller made them. It is the function the
reference computes as ``sha256_batch_pallas(_gather_pack_sha(buffer, offs,
sizes, cap), (sizes + 8) // 64 + 1)``; the plain version below is exactly
that composition in torch. A CPU tensor takes the plain version; a CUDA
tensor launches csrc/sha256.cu or raises. The kernel digests the rows
longest first (:func:`longest_first`), one launch for all of them.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from nydus_snapshotter_tpu_torch.ops import cuda_build, sha256
from nydus_snapshotter_tpu_torch.tensors import MASK32, as_int32

KERNEL = cuda_build.Kernel(
    "sha256.cu",
    "ntpu_sha256_chunks",
    [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_void_p],
)

# Rows per plain-version slice are chosen so one slice's padded blocks stay
# within this many bytes.
_PLAIN_SLICE_BYTES = 1 << 25


def gather_pack_sha(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor, cap_blocks: int
) -> torch.Tensor:
    """Gather chunks at byte-exact offsets and emit SHA-padded blocks.

    -> int32[M, cap_blocks, 16] big-endian words (u32 patterns): bytes
    below ``size``, 0x80 at ``size``, zeros after, and the 64-bit bit
    length in words 14-15 of block (size + 8) // 64. Built one 64-byte
    block column at a time so the index tensor stays [M, 64].
    """
    m = offs.shape[0]
    dev = buffer.device
    out = torch.empty((m, cap_blocks, 16), dtype=torch.int32, device=dev)
    off = offs.to(torch.int64)[:, None]
    size = sizes.to(torch.int64)[:, None]
    last = (size[:, 0] + 8) // 64  # index of the block holding the length
    hi = size[:, 0] >> 29
    lo = (size[:, 0] << 3) & MASK32
    byte_iota = torch.arange(64, dtype=torch.int64, device=dev)
    top = max(buffer.numel() - 1, 0)
    for j in range(cap_blocks):
        pos = j * 64 + byte_iota  # [64] message byte index
        raw = buffer[(off + pos).clamp_(max=top)].to(torch.int64)
        padded = torch.where(pos < size, raw, 0)
        padded = torch.where(pos == size, 0x80, padded)
        b = padded.reshape(m, 16, 4)
        words = (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]
        is_last = last == j
        words[:, 14] = torch.where(is_last, hi, words[:, 14])
        words[:, 15] = torch.where(is_last, lo, words[:, 15])
        out[:, j] = as_int32(words)
    return out


def sha256_chunks_plain(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of K2 (any device): gather + pad + batch
    SHA-256, in row slices so the padded blocks stay bounded.

    The rows are taken longest first, so each slice is padded to the
    blocks of its own first (longest) row: short chunks are never padded
    to the length of a long one in another slice."""
    m = offs.shape[0]
    out = torch.empty((m, 8), dtype=torch.int32, device=buffer.device)
    order = longest_first(sizes).long()
    offs, sizes = offs[order], sizes[order]
    counts = (sizes.to(torch.int64) + 8) // 64 + 1
    counts_host = counts.tolist()
    s = 0
    while s < m:
        cap = counts_host[s]
        e = min(m, s + max(1, _PLAIN_SLICE_BYTES // (cap * 64)))
        blocks = gather_pack_sha(buffer, offs[s:e], sizes[s:e], cap)
        out[order[s:e]] = sha256.sha256_batch(blocks, counts[s:e])
        s = e
    return out


def longest_first(sizes: torch.Tensor) -> torch.Tensor:
    """int32[M] row order for K2: sizes descending, ties in row order.

    The serial floor of a launch is its longest chunk, so the longest
    chunks start first and a warp holds chunks of similar length."""
    return torch.argsort(sizes, descending=True, stable=True).to(torch.int32)


def check_chunk_args(buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor) -> None:
    """The argument contract of the chunk-digest kernels (K2 here, K4 in
    ops/blake3_cuda.py): ``buffer`` u8[N], ``offs``/``sizes`` int32[M] on
    the host with every chunk inside the buffer; a CUDA buffer also
    contiguous, 16-byte aligned and a multiple of 16 bytes long (full
    blocks are read as aligned 16-byte pieces). The extents are checked on
    the host copy: no device read, no wait on the card."""
    if buffer.dtype != torch.uint8 or buffer.dim() != 1:
        raise ValueError(f"buffer must be u8[N], got {buffer.dtype}{list(buffer.shape)}")
    for name, t in (("offs", offs), ("sizes", sizes)):
        if t.dtype != torch.int32 or t.dim() != 1 or t.device.type != "cpu":
            raise ValueError(f"{name} must be int32[M] on the host")
    if offs.shape != sizes.shape:
        raise ValueError("offs and sizes differ in length")
    if offs.shape[0]:
        o = offs.numpy().astype(np.int64)
        s = sizes.numpy().astype(np.int64)
        lo_off, lo_size, hi_end = int(o.min()), int(s.min()), int((o + s).max())
        if lo_off < 0 or lo_size < 0 or hi_end > buffer.numel():
            raise ValueError(
                f"chunk extents leave the buffer (min off {lo_off}, min size "
                f"{lo_size}, max end {hi_end}, buffer {buffer.numel()})"
            )
    if buffer.device.type == "cpu":
        return
    if buffer.device.type != "cuda":
        raise ValueError(f"unsupported device {buffer.device}")
    if not buffer.is_contiguous():
        raise ValueError("buffer must be contiguous")
    if buffer.data_ptr() % 16 or buffer.numel() % 16:
        raise ValueError("buffer must be 16-byte aligned with a length divisible by 16")


def sha256_chunks(
    buffer: torch.Tensor, offs: torch.Tensor, sizes: torch.Tensor
) -> torch.Tensor:
    """buffer u8[N] on any device, offs/sizes int32[M] on the host ->
    int32[M, 8] SHA-256 states on the buffer's device (big-endian words as
    u32 patterns).

    The extents are checked on the host and, for a CUDA buffer, uploaded
    in one non-blocking copy from pinned memory; the row order is sorted on
    the card. The call queues its work and returns without waiting on the
    card."""
    check_chunk_args(buffer, offs, sizes)
    if buffer.device.type == "cpu":
        return sha256_chunks_plain(buffer, offs, sizes)
    m = offs.shape[0]
    out = torch.empty((m, 8), dtype=torch.int32, device=buffer.device)
    if m:
        rows = torch.stack([offs, sizes]).pin_memory()
        with torch.cuda.device(buffer.device):
            ext = rows.to(buffer.device, non_blocking=True)
            perm = longest_first(ext[1])
            KERNEL.launch(
                buffer.data_ptr(), ext[0].data_ptr(), ext[1].data_ptr(), perm.data_ptr(),
                out.data_ptr(), m, torch.cuda.current_stream().cuda_stream,
            )
    return out
